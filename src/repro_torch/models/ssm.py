"""Mamba-1 selective SSM block of the port (``repro.models.ssm``).

``mamba_fwd`` is the full-sequence block without a cache (training, and
the embedding stacks): under autograd its scan is the reference's
``fused_selective_scan`` custom VJP (``fused_selective_scan`` here, the
scan kernel with its boundary states forward and the scan's backward
kernel back; see ``kernels/mamba_scan/ops.py:SelectiveScanFn``), without
autograd the prefill's scan.  Decode is O(1) per token: a conv-window
shift and one state update.  With ``use_kernels`` the step runs the
hand-written CUDA step kernel and the prefill the selective-scan kernel
(``repro_torch.kernels.mamba_scan``); on CPU tensors each wrapper runs its
plain version.  The serving cache, ``{"conv": (B, w-1, d_in), "h": (B,
d_in, N) fp32}``, is updated IN PLACE; ``mamba_fwd`` writes no cache.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_ref,
                                                mamba_step_ref, softplus)

Params = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, dt_rank, state_dim, conv_width)."""
    s = cfg.ssm
    d_inner = s.d_inner or s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.state_dim, s.conv_width


def state_elems(cfg: ModelConfig) -> int:
    """Per-slot recurrent-state elements of ONE mamba block: the conv
    window plus the (d_inner, N) state, constant in sequence length."""
    d_in, _, n, w = dims(cfg)
    return (w - 1) * d_in + d_in * n


def mamba_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
               device) -> Params:
    """Random weights with the reference's init: ``dt_bias`` the inverse
    softplus of a log-uniform dt in [1e-3, 0.1], ``A_log = log(1..N)``,
    ``D = 1``, ``conv_w ~ N(0, 1) / sqrt(w)``, fan-in scaled projections.
    The projections take the activation dtype; conv_w, conv_b, dt_bias,
    A_log and D stay fp32, as the reference computes with them in fp32."""
    d = cfg.d_model
    d_in, dt_rank, n, w = dims(cfg)
    f32 = torch.float32

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device) * std

    u = torch.rand((d_in,), generator=gen, dtype=f32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a = torch.arange(1, n + 1, dtype=f32, device=device).expand(d_in, n)
    return {
        "in_proj": normal((d, 2 * d_in), d ** -0.5),
        "conv_w": normal((w, d_in), w ** -0.5, f32),
        "conv_b": torch.zeros(d_in, dtype=f32, device=device),
        "x_proj": normal((d_in, dt_rank + 2 * n), d_in ** -0.5),
        "dt_proj": normal((dt_rank, d_in), dt_rank ** -0.5),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(a).contiguous(),
        "D": torch.ones(d_in, dtype=f32, device=device),
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def _conv_causal(x, w, b):
    """Depthwise causal conv along S.  x: (B, S, D); w: (W, D) -> (B, S, D)
    in x's dtype, summed in fp32."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def fused_selective_scan(x, dt, b, c, a_log, d, *, use_kernels: bool = True):
    """y (B, S, D) fp32 of the selective scan from a zero state (the
    reference's ``fused_selective_scan``, chunk-boundary states saved and
    recomputed in the backward).  Where autograd records the call it runs
    ``SelectiveScanFn`` (the kernels on the card with ``use_kernels``, the
    plain pair otherwise or on the CPU); else the prefill's scan."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, b, c, a_log, d)):
        return ops.SelectiveScanFn.apply(x, dt, b, c, a_log, d,
                                         not use_kernels)
    scan = ops.mamba_scan if use_kernels else mamba_scan_ref
    return scan(x, dt, b, c, a_log, d)[0]


def mamba_fwd(p: Params, cfg: ModelConfig, x, *, use_kernels: bool = True):
    """Full-sequence Mamba block from a zero state, without a cache.  x:
    (B, S, d) -> (B, S, d).  Weights are cast to x's dtype at use (fp32
    training masters); without autograd the arithmetic is
    ``mamba_prefill``'s."""
    d_in, dt_rank, n, w = dims(cfg)
    act = x.dtype
    xz = x @ p["in_proj"].to(act)
    x_part, z = xz.chunk(2, dim=-1)
    x_conv = F.silu(_conv_causal(x_part, p["conv_w"], p["conv_b"]))
    dbc = x_conv @ p["x_proj"].to(act)
    dt_raw, b_ssm, c_ssm = torch.split(dbc, [dt_rank, n, n], dim=-1)
    dt = softplus((dt_raw @ p["dt_proj"].to(act)).float()
                  + p["dt_bias"].float())
    y = fused_selective_scan(x_conv, dt, b_ssm, c_ssm, p["A_log"], p["D"],
                             use_kernels=use_kernels)
    y = (y * F.silu(z.float())).to(act)
    return y @ p["out_proj"].to(act)


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    d_in, _, n, w = dims(cfg)
    return {"conv": torch.zeros((batch, w - 1, d_in), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_in, n), dtype=torch.float32,
                             device=device)}


def mamba_prefill(p: Params, cfg: ModelConfig, x, cache: Params, *,
                  use_kernels: bool = True):
    """Prompt pass from a zero state.  x: (B, S, d) -> (B, S, d); the
    cache's conv window (the last w-1 pre-conv inputs, zeros before the
    prompt when S < w-1) and final state are written in place."""
    d_in, dt_rank, n, w = dims(cfg)
    S = x.shape[1]
    xz = x @ p["in_proj"]
    x_part, z = xz.chunk(2, dim=-1)
    x_conv = F.silu(_conv_causal(x_part, p["conv_w"], p["conv_b"]))
    dbc = x_conv @ p["x_proj"]
    dt_raw, b_ssm, c_ssm = torch.split(dbc, [dt_rank, n, n], dim=-1)
    dt = softplus((dt_raw @ p["dt_proj"]).float() + p["dt_bias"].float())
    if use_kernels:
        y, h_last = ops.mamba_scan(x_conv, dt, b_ssm, c_ssm, p["A_log"],
                                   p["D"])
    else:
        y, h_last = mamba_scan_ref(x_conv, dt, b_ssm, c_ssm, p["A_log"],
                                   p["D"])
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    keep = min(S, w - 1)
    conv = cache["conv"]
    conv[:, :w - 1 - keep].zero_()
    conv[:, w - 1 - keep:].copy_(x_part[:, S - keep:])
    cache["h"].copy_(h_last)
    return out, cache


def mamba_step(p: Params, cfg: ModelConfig, x1, cache: Params, *,
               use_kernels: bool = False, live=None):
    """One token.  x1: (B, 1, d) -> (B, 1, d); the cache advances in
    place.  With ``use_kernels`` the step kernel runs and rows whose
    ``live`` is false keep their state and output zeros; without, every
    row advances, as the reference's inline chain does."""
    args = (p["in_proj"], p["conv_w"], p["conv_b"], p["x_proj"],
            p["dt_proj"], p["dt_bias"], p["A_log"], p["D"], p["out_proj"])
    if use_kernels:
        out = ops.mamba_step(x1, cache["conv"], cache["h"], *args, live=live)
        return out, cache
    out, new_conv, new_h = mamba_step_ref(x1, cache["conv"], cache["h"],
                                          *args)
    cache["conv"].copy_(new_conv)
    cache["h"].copy_(new_h)
    return out, cache
