"""GQA and cross-attention blocks of the port (``repro.models.attention``
without MLA).

Parameters keep the reference's einsum layouts, ``wq/wk/wv (d, H, hd)`` and
``wo (Hq, hd, d)``, so weights bridge without transposes; the projections
reshape them to matrices at use (views, no copies).  Cache per layer:
``{"k": (B, T, Hkv, D), "v": (B, T, Hkv, D)}``, updated IN PLACE.

With ``use_kernels``, full-sequence attention (prefill, encoders) goes
through the flash kernel's wrapper and decode attention, self and cross,
through the ragged decode kernel's; on CPU tensors each wrapper runs its
plain version.  Cross-attention over a full sequence stays stock torch, as
the reference computes it outside any kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ragged_decode import ragged_decode_attention
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def gqa_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device) -> Params:
    """Random weights with the reference's fan-in scaled init (the numbers
    differ from ``jax.random``'s; tests bridge JAX weights instead)."""
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    std = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, hq, hd), std, dtype, device),
        "wk": _normal(gen, (d, hkv, hd), std, dtype, device),
        "wv": _normal(gen, (d, hkv, hd), std, dtype, device),
        "wo": _normal(gen, (hq, hd, d), 1.0 / math.sqrt(hq * hd), dtype,
                      device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _out(o, wo):
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def _project_qkv(p: Params, cfg: ModelConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg: ModelConfig) -> int:
    return cfg.window_size if cfg.attn_type == "sliding" else 0


def gqa_fwd(p: Params, cfg: ModelConfig, x, positions, *, causal: bool = True,
            is_global: bool = False, kv_len=None, use_kernels: bool = True):
    """Full-sequence attention without a cache (encoders, embedding
    stacks).  kv_len: optional (B,) int32 valid lengths of right-padded
    rows: each row masks its own key padding, so its valid outputs do not
    depend on the padded length."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    kw = dict(causal=causal, window=_window(cfg), logit_cap=cfg.logit_softcap,
              is_global=is_global, kv_len=kv_len)
    if use_kernels:
        o = flash_attention(q, k, v, **kw)
    else:
        o = L.blockwise_attention(q, k, v, **kw)
    return _out(o, p["wo"])


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p: Params, cfg: ModelConfig, x, positions, cache: Params, *,
                is_global: bool = False, use_kernels: bool = True):
    """Prefill: causal attention, and K/V written into the cache at [0, S)
    in place.  ``use_kernels=False`` runs the plain blockwise attention
    whatever the device."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    kw = dict(causal=True, window=_window(cfg), logit_cap=cfg.logit_softcap,
              is_global=is_global)
    if use_kernels:
        o = flash_attention(q, k, v, **kw)
    else:
        o = L.blockwise_attention(q, k, v, **kw)
    S = x.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _out(o, p["wo"]), cache


def gqa_step(p: Params, cfg: ModelConfig, x1, cache: Params, pos, *,
             is_global: bool = False, use_kernels: bool = False,
             kv_bound: Optional[int] = None, live=None):
    """Decode one token.  x1: (B, 1, d); pos: (B,) int32 per-row positions.

    With ``use_kernels`` the ragged kernel reads only ``cache[:, :kv_bound]``
    (a strided view, never copied; the bound covers every live row's
    ``pos + 1``) and ``live`` marks empty slots.  The full-size cache is
    written either way."""
    q, k, v = _project_qkv(p, cfg, x1, pos[:, None])
    ck = L.scatter_kv(cache["k"], k, pos)
    cv = L.scatter_kv(cache["v"], v, pos)
    kw = dict(window=_window(cfg), is_global=is_global,
              logit_cap=cfg.logit_softcap)
    if use_kernels:
        kb = ck.shape[1] if kv_bound is None else kv_bound
        o = ragged_decode_attention(q, ck[:, :kb], cv[:, :kb], pos + 1,
                                    live=live, **kw)
    else:
        o = L.decode_attention(q, ck, cv, pos + 1, **kw)
    return _out(o, p["wo"]), cache


# ---------------------------------------------------------------------------
# cross-attention (enc-dec decoder): K/V from the encoder output, computed
# once at prefill into the slot's cross cache
# ---------------------------------------------------------------------------

def cross_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
               device) -> Params:
    return gqa_init(gen, cfg, dtype=dtype, device=device)


def _cross_q(p: Params, cfg: ModelConfig, x):
    q = _proj(x, p["wq"])
    return q + p["bq"] if cfg.qkv_bias else q


def cross_kv(p: Params, cfg: ModelConfig, enc_out):
    """Encoder output (B, S_src, d) -> cross K, V (B, S_src, Hkv, hd)."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def cross_fwd(p: Params, cfg: ModelConfig, x, enc_out, src_len=None):
    """Cross-attention of x (B, Sq, d) over the encoder output (prefill).

    src_len: optional scalar or (B,) valid source lengths of a right-padded
    encoder output: keys at or past it are masked out of the softmax.  The
    masked path is the reference's einsum form (scores (B, Hq, Sq, S_src),
    small for the decoder prompts a serving prefill runs); without it the
    plain blockwise attention runs, as in the reference."""
    q = _cross_q(p, cfg, x)
    k, v = cross_kv(p, cfg, enc_out)
    if src_len is None:
        o = L.blockwise_attention(q, k, v, causal=False)
    else:
        B, Sq, Hq, D = q.shape
        Ss, Hkv = k.shape[1], k.shape[2]
        kexp = k.repeat_interleave(Hq // Hkv, dim=2)
        vexp = v.repeat_interleave(Hq // Hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         kexp.float()) / math.sqrt(D)
        lens = torch.as_tensor(src_len, device=q.device).expand(B)
        mask = (torch.arange(Ss, device=q.device)[None, None, None, :]
                < lens[:, None, None, None])
        s = torch.where(mask, s, L.NEG_INF)
        w = torch.softmax(s, dim=-1).to(vexp.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w.float(),
                         vexp.float()).to(q.dtype)
    return _out(o, p["wo"])


def cross_step(p: Params, cfg: ModelConfig, x1, ck, cv, src_len, *,
               use_kernels: bool = False, src_bound: Optional[int] = None,
               live=None):
    """Decode-step cross-attention of x1 (B, 1, d) over the slot's cross
    cache (B, max_src, Hkv, hd), each row masked at its ``src_len``.  With
    ``use_kernels`` the ragged kernel reads only ``[:, :src_bound]`` (the
    bound covers every live row's source) and skips dead slots."""
    q = _cross_q(p, cfg, x1)
    if use_kernels:
        sb = ck.shape[1] if src_bound is None else src_bound
        o = ragged_decode_attention(q, ck[:, :sb], cv[:, :sb], src_len,
                                    live=live)
    else:
        o = L.decode_attention(q, ck, cv, src_len)
    return _out(o, p["wo"])
