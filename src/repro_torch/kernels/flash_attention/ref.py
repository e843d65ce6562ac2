"""Plain PyTorch version of the flash attention kernel.

The kernel implements the contract of the reference's
``layers.blockwise_attention`` (causal or not, sliding window with a
global-layer bypass, logit soft-cap, GQA by head index, per-row key
padding), so its plain version is the port of that function, with the
reference's default block of 512 keys.
"""
from __future__ import annotations

from repro_torch.models.layers import blockwise_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, is_global=None, kv_len=None):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D); kv_len:
    optional (B,) valid keys per row."""
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               logit_cap=logit_cap, is_global=is_global,
                               kv_len=kv_len)
