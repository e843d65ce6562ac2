"""Dense FFN of the port (``repro.models.moe``, dense part only).

The routed mixture of experts belongs to a later slice of the port.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def ffn_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int, *, dtype,
             device) -> Dict[str, torch.Tensor]:
    """Plain (or GLU) MLP weights, fan-in scaled as in the reference."""
    d = cfg.d_model

    def w(shape):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device) * (1.0 / math.sqrt(shape[0]))

    p = {"w_up": w((d, d_ff)), "w_down": w((d_ff, d))}
    if cfg.glu:
        p["w_gate"] = w((d, d_ff))
    return p


def ffn_apply(p: Dict[str, torch.Tensor], cfg: ModelConfig, x):
    act = L.activation(cfg.act)
    up = x @ p["w_up"]
    if cfg.glu:
        h = act(x @ p["w_gate"]) * up
    else:
        h = act(up)
    return h @ p["w_down"]
