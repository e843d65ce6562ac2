"""The paper's own evaluation workloads, expressed as MM-layer DAGs.

FILCO's experiments (Figs 1, 8–10) run on MLP / DeiT / PointNet / BERT-n
matrix-multiply workloads.  The DSE consumes a DAG of layers where each node
is a matmul with shape (M, K, N); these builders generate exactly those DAGs.

Batch conventions follow the paper's framing: BERT-n = BERT-base encoder with
sequence length n; MLP-L/S from [Wang et al., arXiv:1907.10701]; DeiT-B/S from
[arXiv:2012.12877]; PointNet per [arXiv:1612.00593] with its T-Net MMs (the
source of its "highest diversity").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MMLayer:
    """One matmul node: (M x K) @ (K x N), ``deps`` = indices it depends on."""

    name: str
    m: int
    k: int
    n: int
    deps: Tuple[int, ...] = ()

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n

    @property
    def bytes_io(self) -> float:  # fp32 operands + result, single pass
        return 4.0 * (self.m * self.k + self.k * self.n + self.m * self.n)


@dataclasses.dataclass(frozen=True)
class MMWorkload:
    name: str
    layers: Tuple[MMLayer, ...]

    @property
    def total_flops(self) -> float:
        return sum(l.flops for l in self.layers)

    def diversity(self) -> float:
        """Shape-diversity metric: mean pairwise log-ratio distance of
        (M,K,N) across layers (0 = all identical).  Used to place workloads
        on the Fig. 9 diversity axis."""
        import math

        dims = [(l.m, l.k, l.n) for l in self.layers]
        if len(dims) < 2:
            return 0.0
        tot, cnt = 0.0, 0
        for i in range(len(dims)):
            for j in range(i + 1, len(dims)):
                a, b = dims[i], dims[j]
                tot += sum(abs(math.log2(x / y)) for x, y in zip(a, b)) / 3.0
                cnt += 1
        return tot / cnt


def _chain(layers: Sequence[Tuple[str, int, int, int]]) -> Tuple[MMLayer, ...]:
    out: List[MMLayer] = []
    for i, (nm, m, k, n) in enumerate(layers):
        out.append(MMLayer(nm, m, k, n, deps=(i - 1,) if i else ()))
    return tuple(out)


# ---------------------------------------------------------------------------
# MLP (near-square MMs, lowest diversity).  MLP-L/S per the paper's framing of
# large vs small classifier MLPs (batch x hidden chains).
# ---------------------------------------------------------------------------

def mlp(batch: int = 1024, hidden: int = 4096, depth: int = 6, name: str = "MLP-L") -> MMWorkload:
    return MMWorkload(name, _chain([(f"fc{i}", batch, hidden, hidden) for i in range(depth)]))


MLP_L = mlp(1024, 4096, 6, "MLP-L")
MLP_M = mlp(512, 2048, 6, "MLP-M")
MLP_S = mlp(64, 512, 6, "MLP-S")


# ---------------------------------------------------------------------------
# BERT-base encoder at sequence length s: per layer
#   QKV (3x), attn scores/values (per-head, folded into two batched MMs),
#   output proj, FFN up, FFN down.  Medium diversity.
# ---------------------------------------------------------------------------

def bert(seq: int, d: int = 768, heads: int = 12, d_ff: int = 3072,
         layers: int = 12, name: str | None = None) -> MMWorkload:
    hd = d // heads
    nodes: List[MMLayer] = []
    prev = ()
    for li in range(layers):
        base = len(nodes)
        q = MMLayer(f"l{li}.q", seq, d, d, prev)
        k = MMLayer(f"l{li}.k", seq, d, d, prev)
        v = MMLayer(f"l{li}.v", seq, d, d, prev)
        nodes += [q, k, v]
        # scores: heads x (seq x hd) @ (hd x seq)  -> flattened batched MM
        s = MMLayer(f"l{li}.qk", heads * seq, hd, seq, (base, base + 1))
        nodes.append(s)
        a = MMLayer(f"l{li}.av", heads * seq, seq, hd, (base + 3, base + 2))
        nodes.append(a)
        o = MMLayer(f"l{li}.o", seq, d, d, (base + 4,))
        nodes.append(o)
        f1 = MMLayer(f"l{li}.ffn1", seq, d, d_ff, (base + 5,))
        nodes.append(f1)
        f2 = MMLayer(f"l{li}.ffn2", seq, d_ff, d, (base + 6,))
        nodes.append(f2)
        prev = (base + 7,)
    return MMWorkload(name or f"BERT-{seq}", tuple(nodes))


BERT_32 = bert(32)
BERT_64 = bert(64)
BERT_128 = bert(128)
BERT_256 = bert(256)
BERT_512 = bert(512)
BERT_SERIES = (BERT_32, BERT_64, BERT_128, BERT_256, BERT_512)


# ---------------------------------------------------------------------------
# DeiT (ViT): patches = (img/16)^2 (+1 cls).  DeiT-B: d=768, DeiT-S: d=384.
# Attention vs FFN shape mismatch = medium-high diversity.
# ---------------------------------------------------------------------------

def deit(d: int = 768, heads: int = 12, layers: int = 12, img: int = 224,
         name: str = "DeiT-B") -> MMWorkload:
    seq = (img // 16) ** 2 + 1
    return bert(seq, d=d, heads=heads, d_ff=4 * d, layers=layers, name=name)


DEIT_B = deit(768, 12, 12, 224, "DeiT-L")   # paper labels the larger DeiT "DeiT-L"
DEIT_S = deit(384, 6, 12, 224, "DeiT-S")


# ---------------------------------------------------------------------------
# PointNet: per-point shared MLPs (N points x small channels) + T-Net (3x3 and
# 64x64 transform regressors) -> extreme intra-model shape variance.
# ---------------------------------------------------------------------------

def pointnet(n_points: int = 1024, name: str = "PointNet") -> MMWorkload:
    nodes: List[MMLayer] = []

    def add(nm, m, k, n, deps=()):
        nodes.append(MMLayer(nm, m, k, n, deps))
        return len(nodes) - 1

    # input T-Net (3x3): mlp 3->64->128->1024, fc 1024->512->256->9
    i0 = add("tnet1.c1", n_points, 3, 64)
    i1 = add("tnet1.c2", n_points, 64, 128, (i0,))
    i2 = add("tnet1.c3", n_points, 128, 1024, (i1,))
    i3 = add("tnet1.f1", 1, 1024, 512, (i2,))
    i4 = add("tnet1.f2", 1, 512, 256, (i3,))
    i5 = add("tnet1.f3", 1, 256, 9, (i4,))
    t1 = add("tnet1.apply", n_points, 3, 3, (i5,))
    # mlp1 3->64->64
    m0 = add("mlp1.c1", n_points, 3, 64, (t1,))
    m1 = add("mlp1.c2", n_points, 64, 64, (m0,))
    # feature T-Net (64x64)
    f0 = add("tnet2.c1", n_points, 64, 64, (m1,))
    f1 = add("tnet2.c2", n_points, 64, 128, (f0,))
    f2 = add("tnet2.c3", n_points, 128, 1024, (f1,))
    f3 = add("tnet2.f1", 1, 1024, 512, (f2,))
    f4 = add("tnet2.f2", 1, 512, 256, (f3,))
    f5 = add("tnet2.f3", 1, 256, 64 * 64, (f4,))
    t2 = add("tnet2.apply", n_points, 64, 64, (f5, m1))
    # mlp2 64->64->128->1024
    g0 = add("mlp2.c1", n_points, 64, 64, (t2,))
    g1 = add("mlp2.c2", n_points, 64, 128, (g0,))
    g2 = add("mlp2.c3", n_points, 128, 1024, (g1,))
    # classifier head 1024->512->256->40
    h0 = add("cls.f1", 1, 1024, 512, (g2,))
    h1 = add("cls.f2", 1, 512, 256, (h0,))
    add("cls.f3", 1, 256, 40, (h1,))
    return MMWorkload(name, tuple(nodes))


POINTNET = pointnet(1024, "PointNet-L")
POINTNET_S = pointnet(256, "PointNet-S")

PAPER_WORKLOADS: Dict[str, MMWorkload] = {
    w.name: w
    for w in (MLP_L, MLP_M, MLP_S, BERT_32, BERT_64, BERT_128, BERT_256,
              BERT_512, DEIT_B, DEIT_S, POINTNET, POINTNET_S)
}
