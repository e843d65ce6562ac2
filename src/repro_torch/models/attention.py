"""GQA attention block of the port (``repro.models.attention``, GQA half).

Parameters keep the reference's einsum layouts, ``wq/wk/wv (d, H, hd)`` and
``wo (Hq, hd, d)``, so weights bridge without transposes; the projections
reshape them to matrices at use (views, no copies).  Cache per layer:
``{"k": (B, T, Hkv, D), "v": (B, T, Hkv, D)}``, updated IN PLACE.

Prefill attention always goes through the flash kernel's wrapper and
decode attention, with ``use_kernels``, through the ragged decode kernel's;
on CPU tensors each wrapper runs its plain version.
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
