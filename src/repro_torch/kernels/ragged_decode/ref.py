"""Plain PyTorch version of the ragged decode attention kernel.

Port of ``repro.kernels.ragged_decode.ref``: op for op the padded
``layers.decode_attention`` (same products, mask order and NEG_INF fill),
plus the ragged extensions the kernel implements: per-row true ``lengths``
and a ``live`` row mask whose dead rows return exact zeros.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import decode_attention


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
