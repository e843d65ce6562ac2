"""Plain PyTorch versions of the ragged decode attention kernel.

``ragged_decode_attention_ref`` is the port of
``repro.kernels.ragged_decode.ref``: op for op the padded
``layers.decode_attention`` (same products, mask order and NEG_INF fill),
plus the ragged extensions the kernel implements: per-row true ``lengths``
and a ``live`` row mask whose dead rows return exact zeros.  The kernel's
wrapper takes it for CPU tensors.

``ragged_decode_split_ref`` is the CUDA kernel's split-KV algorithm in
plain PyTorch, its executable spec: a KV head's query heads cut into the
kernel's head groups (``head_groups``), and per group and chunk of KV rows
a partial (max, sum, unnormalised accumulator), an empty chunk as
(NEG_INF, 0, 0), then the merge.  Nothing on the serving path calls it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import NEG_INF, decode_attention

GROUP = 8                     # query heads one kernel block holds at most


def head_groups(G: int):
    """(groups, gsize): the G query heads of a KV head cut into the fewest
    groups of at most ``GROUP`` heads, as even as they come (the last
    group the shorter): 48 -> 6 x 8, 9 -> 5 + 4, 5 -> 1 x 5."""
    groups = -(-G // GROUP)
    return groups, -(-G // groups)


def ragged_decode_attention_ref(q, k, v, lengths, *, window: int = 0,
                                logit_cap: float = 0.0, is_global=None,
                                live=None):
    """q: (B, 1, Hq, D); k, v: (B, T, Hkv, D); lengths: int or (B,) valid
    KV entries per row (current token included); live: optional (B,) bool
    -> (B, 1, Hq, D)."""
    out = decode_attention(q, k, v, lengths, window=window,
                           logit_cap=logit_cap, is_global=is_global)
    if live is not None:
        out = torch.where(live.to(torch.bool)[:, None, None, None], out,
                          torch.zeros_like(out))
    return out


def ragged_decode_partials(q, k, v, lengths, *, chunk: int, window: int = 0,
                           logit_cap: float = 0.0, is_global=None,
                           live=None):
    """Per-chunk partials of the split kernel, in fp32: m, l of (B, Hq, n)
    and acc of (B, Hq, n, D) over n = ceil(T / chunk) chunks.  A chunk
    holds the rows [i * chunk, (i + 1) * chunk) that lie in [window start,
    length); lengths clamp to [1, T]; a chunk with no such row, and every
    chunk of a dead row, is (NEG_INF, 0, 0)."""
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    lens = torch.as_tensor(lengths, device=dev).expand(B).clamp(1, T)
    start = torch.zeros_like(lens)
    if window and not is_global:
        start = (lens - window).clamp(min=0)
    pos = torch.arange(T, device=dev)
    valid = (pos[None, :] >= start[:, None]) & (pos[None, :] < lens[:, None])
    if live is not None:
        valid = valid & live.to(device=dev, dtype=torch.bool)[:, None]
    kexp = k.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(),
                     kexp.float()) / math.sqrt(D)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    n = -(-T // chunk)
    pad = n * chunk - T
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, Hq, n, chunk)
    ok = torch.nn.functional.pad(valid, (0, pad)).reshape(B, 1, n, chunk)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)                                      # NEG_INF if empty
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    vexp = torch.nn.functional.pad(
        v.repeat_interleave(Hq // Hkv, dim=2).float(), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bhnc,bnchd->bhnd", p,
                       vexp.reshape(B, n, chunk, Hq, D))
    return m, l, acc


def ragged_decode_split_ref(q, k, v, lengths, *, chunk: int, window: int = 0,
                            logit_cap: float = 0.0, is_global=None,
                            live=None):
    """The split kernel's result: per head group of each KV head, its
    partials merged with weights exp(m_i - M) over the non-empty chunks,
    divided by l only where l > 0, dead rows exact zeros -> (B, 1, Hq, D)
    in q's dtype."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    groups, gsize = head_groups(G)
    qg = q.reshape(B, 1, Hkv, G, D)
    outs = []
    for i in range(groups):
        heads = qg[:, :, :, i * gsize:min(G, (i + 1) * gsize)]
        n = heads.shape[3]
        m, l, acc = ragged_decode_partials(
            heads.reshape(B, 1, Hkv * n, D), k, v, lengths, chunk=chunk,
            window=window, logit_cap=logit_cap, is_global=is_global,
            live=live)
        full = l > 0
        M = torch.where(full, m, NEG_INF).amax(dim=-1, keepdim=True)
        w = torch.where(full, torch.exp(m - M), 0.0)
        L = (w * l).sum(dim=-1)
        out = (w[..., None] * acc).sum(dim=-2)
        out = out / torch.where(L > 0, L, 1.0)[..., None]
        outs.append(out.reshape(B, Hkv, n, D))
    return torch.cat(outs, dim=2).reshape(B, 1, Hq, D).to(q.dtype)
