"""Plain PyTorch versions of the flash attention kernels.

The forward kernel implements the contract of the reference's
``layers.blockwise_attention`` (causal or not, sliding window with a
global-layer bypass, logit soft-cap, GQA by head index, per-row key
padding), so its plain version is the port of that function, with the
reference's default block of 512 keys.  The training forward adds the
log-sum-exp (the reference's ``_flash_fwd_pass``), and the backward kernel's
plain version is the port of the reference's ``_flash_bwd`` on given
(out, lse).
"""
from __future__ import annotations

from repro_torch.models.layers import (blockwise_attention, flash_backward,
                                       flash_forward)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, is_global=None, kv_len=None):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D); kv_len:
    optional (B,) valid keys per row."""
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               logit_cap=logit_cap, is_global=is_global,
                               kv_len=kv_len)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True):
    """(out (B, S, Hq, D), lse (B, S, Hq) fp32)."""
    return flash_forward(q, k, v, causal=causal)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True):
    """(dq, dk, dv) for the output gradient ``dout`` of the attention
    whose forward gave ``out`` and ``lse``."""
    return flash_backward(q, k, v, out, dout, lse, causal=causal)
