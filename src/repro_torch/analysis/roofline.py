"""Roofline terms of a step on one H100, and the bounds of the port's
kernels (the counterpart of ``src/repro/analysis/roofline.py``).

  compute term    = FLOPs / (chips x peak FLOP/s)
  memory term     = bytes / (chips x HBM bandwidth)
  collective term = collective bytes / (chips x link bandwidth x links)

priced on a ``PlatformProfile``, ``H100_SXM`` by default.  The FLOPs and
bytes come from ``repro_torch.analysis.opcount`` (a step traced on
``meta`` tensors), not from a compiled program: the port has no HLO, so
the reference's ``collective_bytes_from_hlo`` and ``scan_trip_multiplier``
have no counterpart here.  Its layer loop is Python, so every layer's
operations are counted as they run and no trip count multiplies them.
One card has no link: ``CollectiveStats`` stays and is empty, and the
collective term is 0.

``kernel_bound`` is the least time of a kernel's work on the card, the
larger of its bytes over the HBM bandwidth and its operations over the
peak of their type (``PERF.md``'s kernel table reads its bounds from it).
The ``*_work`` functions give each hand-written kernel's bytes and
operations, as its table row counts them; ``opcount`` counts a kernel's
launch on ``meta`` tensors by the same formula.  ``training_flops`` is the
port's FLOP count of its own remat training step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.common.platform import H100_SXM, PlatformProfile

# -- the card's rates (H100 SXM data sheet, dense) ---------------------------
HBM_BYTES_PER_S = H100_SXM.hbm_bw        # 3.35 TB/s
BF16_FLOPS = H100_SXM.peak_flops         # bf16 on the tensor cores
TF32_FLOPS = 495e12                      # TF32 on the tensor cores
F32_FLOPS = 67e12                        # fp32 outside the tensor cores
# exponentials on the special-function units: 16 per clock per SM at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the H100 SXM's 1980 MHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# exponentials evaluated beside them on the FP32 pipe (128 lanes per SM),
# as range reduction plus a polynomial: about 8 FP32 instructions each.
# The bound counts both, so that it is the least time
FMA_EXP_PER_S = 132 * 128 * 1.98e9 / 8


def kernel_bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0,
                 tf32x3: bool = False) -> Tuple[float, str]:
    """Least time in ms for ``nbytes`` of traffic, ``flops`` at the peak of
    ``dtype`` and ``exps`` exponentials on the special-function units and
    the FP32 pipe together, and which of "bytes" or "operations" binds.
    With ``tf32x3`` an fp32 product is three TF32 tensor-core products
    (the filco_mm kernel's fp32 arithmetic): 3 x ``flops`` at the TF32
    peak."""
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    if tf32x3 and dtype == "float32":
        flops, peak = 3 * flops, TF32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / peak, exps / (SFU_EXP_PER_S + FMA_EXP_PER_S))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the kernels' work: (bytes, flops[, exponentials]) as the bounds count it
# ---------------------------------------------------------------------------

def attended_pairs(B: int, S: int, H: int, causal: bool,
                   Skv: int = None) -> int:
    """(query, key) pairs of B x H heads of S queries, over Skv keys where
    bidirectional (None: S)."""
    return B * H * (S * (S + 1) // 2 if causal
                    else S * (S if Skv is None else Skv))


def window_pairs(B: int, S: int, H: int, window: int) -> int:
    """Attended (query, key) pairs of causal attention under a sliding
    window: query i sees min(i + 1, window) keys."""
    W = min(window, S)
    return B * H * (W * (W + 1) // 2 + (S - W) * W)


def flash_pairs(B: int, S: int, Skv: int, H: int, causal: bool,
                window: int = 0, is_global=None) -> int:
    """The pairs one flash call attends: the window's where one slides
    (and the layer is not global), else the causal or full ones."""
    if window and not is_global:
        return window_pairs(B, S, H, window)
    return attended_pairs(B, S, H, causal, Skv)


def flash_work(q_numel: int, kv_numel: int, D: int, pairs: int, es: int,
               lse_numel: int = 0) -> Tuple[int, int]:
    """The flash forward: q, k, v read and out written once (the fp32 lse
    beside it with ``lse_numel``), 4 D flops a pair (two products)."""
    return (2 * q_numel + kv_numel) * es + 4 * lse_numel, 4 * D * pairs


def flash_bwd_work(q_numel: int, kv_numel: int, D: int, pairs: int, es: int,
                   lse_numel: int) -> Tuple[int, int]:
    """The flash backward: q, k, v, out and dout read, dq, dk, dv written,
    the fp32 lse read; 10 D flops a pair (five products: the recomputed
    scores, dP, dV, dQ, dK)."""
    return 2 * (q_numel + kv_numel) * es + 2 * q_numel * es \
        + 4 * lse_numel, 10 * D * pairs


def ragged_decode_work(B: int, Hq: int, Hkv: int, D: int, es: int,
                       rows: int) -> Tuple[int, int]:
    """Ragged decode over ``rows`` live KV rows (the sum of the live
    slots' lengths): each row's K and V read once, q read and the output
    written, 8 bytes of length and liveness a slot; 4 D flops a (row,
    query head)."""
    return (2 * rows * Hkv * D * es + 2 * B * Hq * D * es + 8 * B,
            4 * rows * Hq * D)


def mamba_step_work(B: int, d_model: int, d_in: int, R: int, N: int, w: int,
                    es: int, live: int) -> Tuple[int, int, int]:
    """One Mamba decode step for ``live`` of B slots: each weight read
    once, the fp32 conv and A/D parameters, x read and out written, the
    live rows' conv window and state read and written; 2 flops a weight
    element and live row; d_in (N + 3) exponentials a live row."""
    products = (d_model * 2 * d_in + d_in * (R + 2 * N) + R * d_in
                + d_in * d_model)
    fp32_params = w * d_in + 3 * d_in + d_in * N
    state = (w - 1) * d_in * es + d_in * N * 4
    nbytes = (products * es + fp32_params * 4 + 2 * B * d_model * es
              + 2 * live * state + 4 * B)
    return nbytes, 2 * live * products, live * d_in * (N + 3)


def scan_work(B: int, S: int, D: int, N: int, es: int) -> Tuple[int, int, int]:
    """(bytes, exponentials, flops) of the serving scan: x, dt, B, C,
    A_log and D read once, y (fp32) and the last state written once; one
    exponential per state-step and per A; six flops per state-step, three
    per output."""
    n_io = B * S * D
    nbytes = (n_io * es + n_io * 4 + 2 * B * S * N * es + 4 * D * (N + 1)
              + n_io * 4 + 4 * B * D * N)
    return nbytes, n_io * N + D * N, 6 * n_io * N + 3 * n_io


def scan_train_work(B: int, S: int, D: int, N: int, es: int):
    """(forward bytes, backward bytes, exponentials, forward flops,
    backward flops) of the scan's training pair.  The forward reads x, dt,
    B, C, A_log and D and writes y, the last state and the boundary
    states; the backward reads x, dt, B, C, A_log, D, the boundaries and
    gy and writes dx, ddt, dB, dC, dA and dD.  One exponential per
    state-step (the backward needs a_t once; the kernel takes it twice,
    once to recompute the state and once to carry g); six flops per
    state-step and three per output forward, 18 and 7 backward."""
    n = B * S * D
    bc = 2 * B * S * N * es
    par = 4 * D * (N + 1)
    bnd = 4 * -(-S // 32) * B * D * N
    fwd = n * es + n * 4 + bc + par + n * 4 + 4 * B * D * N + bnd
    bwd = n * es + n * 4 + bc + par + bnd + n * 4 + n * es + n * 4 + bc + par
    return fwd, bwd, n * N, 6 * n * N + 3 * n, 18 * n * N + 7 * n


def mm_work(m: int, k: int, n: int, es: int) -> Tuple[int, int]:
    """An (m, k) x (k, n) product: both operands read, the result written
    once; 2 m k n flops."""
    return (m * k + k * n + m * n) * es, 2 * m * k * n


# ---------------------------------------------------------------------------
# the port's remat training step
# ---------------------------------------------------------------------------

def training_flops(model, params, T: int, B: int, S: int,
                   S_src: int = 0, early_stop: bool = False) -> float:
    """Model FLOPs of one remat training step: 8 N T for the weight
    products (6 N T forward and backward, 2 N T the remat forward; N the
    matrices a token passes through: the layers' and the LM head, of an MoE
    layer's routed experts top_k of E, as the model routes, its router and
    shared experts whole), 8 (Dqk + Dv) per attended pair per layer for
    attention (forward, remat forward, backward; 16 D where both are D),
    over the window's pairs on sliding layers and none on attention-free
    ones.  A Mamba block's scan is elementwise and not counted.  An
    enc-dec model over ``S_src`` source frames a row adds 8 N_src B S_src
    (N_src: the encoder layers' matrices and the cross layers' K and V
    projections, which the source frames pass through), S_src^2 pairs a
    head in each encoder layer and S S_src in each cross layer.  Reads
    only the parameters' shapes, so ``meta`` parameters do.

    ``early_stop``: the step as torch runs it.  The layers' non-reentrant
    checkpoints stop their recompute once every saved tensor is back
    (``torch.utils.checkpoint``'s early stop), so a layer's last product,
    whose output no backward node saves, is never recomputed: 2 N_last T
    less a layer, N_last the down projection of a dense FFN, or the out
    projection of a Mamba layer without one (MoE layers: not counted)."""
    from repro_torch.optim import tree_leaves
    cfg = model.cfg
    layers = params["decoder"]["prologue"] + params["decoder"]["layers"]

    def matrices(tree, share=1.0):
        return share * sum(p.numel() for p in tree_leaves(tree)
                           if p.ndim >= 2)

    n_mm = n_src = 0.0
    for lp in layers:
        for key, sub in lp.items():
            if key == "moe":
                mo = cfg.moe
                n_mm += sum(matrices(t, mo.top_k / mo.num_experts
                                     if k == "experts" else 1.0)
                            for k, t in sub.items())
            elif key == "cross":
                kv = {k: t for k, t in sub.items() if k in ("wk", "wv")}
                n_src += matrices(kv)
                n_mm += matrices(sub) - matrices(kv)
            else:
                n_mm += matrices(sub)
    n_mm += params["lm_head"].numel() if "lm_head" in params else \
        params["embed"].numel()
    if cfg.mla is not None:
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.resolved_head_dim
    pairs = 0
    for i, lp in enumerate(layers):
        if "attn" not in lp:          # attention-free Mamba
            continue
        sliding = (cfg.attn_type == "sliding"
                   and i not in cfg.global_attn_layers)
        pairs += (window_pairs(B, S, cfg.num_heads, cfg.window_size)
                  if sliding else attended_pairs(B, S, cfg.num_heads, True))
        if "cross" in lp:
            pairs += attended_pairs(B, S, cfg.num_heads, False, S_src)
    def last(lp):
        if "ffn" in lp:
            return lp["ffn"]["w_down"].numel()
        return lp["ssm"]["out_proj"].numel() if "ssm" in lp and \
            "moe" not in lp else 0

    skipped = sum(last(lp) for lp in layers) * T if early_stop else 0
    if cfg.is_encdec:
        enc = params["encoder"]["layers"]
        n_src += sum(matrices(lp) for lp in enc)
        pairs += len(enc) * attended_pairs(B, S_src, cfg.num_heads, False)
        if early_stop:
            skipped += sum(last(lp) for lp in enc) * B * S_src
    return (8.0 * n_mm * T + 8.0 * n_src * B * S_src
            + 8.0 * (dqk + dv) * pairs - 2.0 * skipped)


# ---------------------------------------------------------------------------
# the reference's terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    """Collective bytes and counts by kind; empty on one card."""
    bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    count_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    cell: str
    mesh: str
    chips: int
    # per-device quantities
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    # derived terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    # model-level accounting
    model_flops: float                 # 6*N*D (or 6*N_active*D)
    hlo_flops_total: float             # the counted FLOPs x chips
    peak_memory_bytes: float = 0.0
    peak_flops: float = H100_SXM.peak_flops   # the platform's, per chip

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return (self.model_flops / self.hlo_flops_total
                if self.hlo_flops_total else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the program runs at
        its bound: (useful FLOPs / chips / peak) / bound_s."""
        if self.bound_s <= 0:
            return 0.0
        ideal_s = self.model_flops / (self.chips * self.peak_flops)
        return ideal_s / self.bound_s

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_total": self.hlo_flops_total,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_memory_gib": self.peak_memory_bytes / (1 << 30),
        }


def derive_terms(*, arch: str, cell: str, mesh_name: str, chips: int,
                 cost: Dict[str, float], collective: CollectiveStats,
                 model_flops: float, peak_memory_bytes: float = 0.0,
                 platform: PlatformProfile = H100_SXM) -> RooflineTerms:
    """The three terms of ``cost`` ({"flops", "bytes accessed"} per device)
    on ``platform``.  With no collective bytes the collective term is 0,
    whatever the links (one card has none); collective bytes on a
    platform without links raise."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = collective.total_bytes
    link_bw = platform.ici_bw * platform.ici_links
    if coll_dev and not link_bw:
        raise ValueError(f"{coll_dev} collective bytes on {platform.name}, "
                         f"which has no inter-chip link")
    return RooflineTerms(
        arch=arch, cell=cell, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev,
        compute_s=flops_dev / platform.peak_flops,
        memory_s=bytes_dev / platform.hbm_bw,
        collective_s=coll_dev / link_bw if coll_dev else 0.0,
        model_flops=model_flops,
        hlo_flops_total=flops_dev * chips,
        peak_memory_bytes=peak_memory_bytes,
        peak_flops=platform.peak_flops,
    )


def model_flops_for(cfg, cell) -> float:
    """MODEL_FLOPS: 6*N*D for training; 2*N*D for inference (fwd only),
    with N = active params (MoE) and D = processed tokens."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch
