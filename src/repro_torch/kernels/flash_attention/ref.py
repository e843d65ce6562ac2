"""Plain PyTorch versions of the flash attention kernels.

The forward kernel implements the contract of the reference's
``layers.blockwise_attention`` (causal or not, sliding window with a
global-layer bypass, logit soft-cap, GQA by head index, per-row key
padding), so its plain version is the port of that function, with the
reference's default block of 512 keys.  The training forward adds the
log-sum-exp (the reference's ``_flash_fwd_pass``), and the backward kernel's
plain version is the port of the reference's ``_flash_bwd`` on given
(out, lse); ``flash_attention_bwd_split_ref`` is the same with the kernel's
split of each KV head's query heads and its fold of the partials.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (blockwise_attention, flash_backward,
                                       flash_forward)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, is_global=None, kv_len=None):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D); kv_len:
    optional (B,) valid keys per row."""
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               logit_cap=logit_cap, is_global=is_global,
                               kv_len=kv_len)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            is_global=None):
    """(out (B, S, Hq, D), lse (B, S, Hq) fp32); ``window`` and
    ``is_global`` as ``flash_attention_ref`` takes them."""
    return flash_forward(q, k, v, causal=causal, window=window,
                         is_global=is_global)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                            window: int = 0, is_global=None):
    """(dq, dk, dv) for the output gradient ``dout`` of the attention
    whose forward gave ``out`` and ``lse``, under the same mask."""
    return flash_backward(q, k, v, out, dout, lse, causal=causal,
                          window=window, is_global=is_global)


def flash_attention_bwd_split_ref(q, k, v, out, dout, lse, *,
                                  causal: bool = True, n_split: int = 1):
    """``flash_attention_bwd_ref`` with each KV head's G query heads taken
    in ``n_split`` runs of G / n_split consecutive heads, as the kernel's
    dK/dV launch takes them (``ops.bwd_plan``): each run's dK and dV
    summed in fp32, the runs' partials summed in split order and rounded
    once to the input dtype.  dq is per head, as unsplit."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if n_split < 1 or G % n_split:
        raise ValueError(f"n_split {n_split} does not divide G = {G}")
    heads = torch.arange(Hq, device=q.device).view(Hkv, n_split, G // n_split)
    dq = torch.empty_like(q)
    dk = dv = None
    for s in range(n_split):
        sel = heads[:, s].reshape(-1)
        dq_s, dk_s, dv_s = flash_backward(
            q[:, :, sel], k, v, out[:, :, sel], dout[:, :, sel],
            lse[:, :, sel], causal=causal, kv_grad_dtype=torch.float32)
        dq[:, :, sel] = dq_s
        dk = dk_s if dk is None else dk + dk_s
        dv = dv_s if dv is None else dv + dv_s
    return dq, dk.to(k.dtype), dv.to(v.dtype)
