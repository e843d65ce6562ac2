"""Architecture registry of the port: ``--arch <id>`` resolution.

Every architecture of the reference is registered: the dense GQA
decoders (minitron, qwen2.5, granite with multi-query attention, qwen1.5
with QKV bias, chameleon with QK-norm), the attention-free Mamba decoder
(falcon-mamba), the hybrid attention-beside-Mamba decoder (hymba), the
seamless-m4t encoder-decoder and the MoE decoders (deepseek-v2-lite with
MLA, and arctic).  arctic and qwen1.5 do not fit one card at full size and
run reduced only.  Any other arch id raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (ALL_CELLS, CELLS_BY_NAME, DECODE_32K,
                                      LONG_500K, PREFILL_32K, TRAIN_4K,
                                      MLAConfig, MoEConfig, ModelConfig,
                                      ShapeCell, SSMConfig, cells_for,
                                      torch_dtype)

_MODULES: Dict[str, str] = {
    "minitron-4b": "minitron_4b",
    "qwen2.5-32b": "qwen2_5_32b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "arctic-480b": "arctic_480b",
    "granite-34b": "granite_34b",
    "qwen1.5-110b": "qwen1_5_110b",
    "chameleon-34b": "chameleon_34b",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def _load(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r} in the port; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _load(arch).REDUCED


__all__ = ["ALL_CELLS", "ARCH_IDS", "CELLS_BY_NAME", "DECODE_32K",
           "LONG_500K", "MLAConfig", "MoEConfig", "ModelConfig",
           "PREFILL_32K", "SSMConfig", "ShapeCell", "TRAIN_4K", "cells_for",
           "get_config", "get_reduced", "torch_dtype"]
