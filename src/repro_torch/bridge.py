"""Weight bridge: the JAX package's parameter tree -> the port's params.

The caller hands over plain numpy arrays (the reference's params after
``strip`` and ``np.asarray``), so this module never sees JAX.  The bridge
unstacks the reference's ``scanned`` leading layer axis into a list of
per-layer dicts (the decoder's, with its cross layers, and an enc-dec's
encoder stack beside ``frame_norm``), converts the decoder's unscanned
``prologue`` layers as they are, leaves the MoE experts stacked on their
expert axis (``w_up (E, d, f)``) and keeps every layout as it is
(``wq (d, H, hd)``, ``wo (Hq, hd, d)``, ``embed (padded_vocab, d)``,
``lm_head (d, padded_vocab)``, ``in_proj (d, 2 d_in)``), so nothing is
transposed.  A hybrid layer carries both blocks, ``attn`` and ``ssm``, and
their output norms, ``attn_out_norm`` and ``ssm_out_norm``.
Weights are cast once to the activation dtype (or to ``dtype``: fp32
masters for training); norm parameters and the Mamba block's conv_w,
conv_b, dt_bias, A_log and D stay fp32, as the reference holds them in
fp32 and casts each to fp32 at use.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import check_supported

_NORMS = ("ln1", "ln2", "ln_cross", "final_norm", "frame_norm", "q_norm",
          "k_norm", "kv_norm", "attn_out_norm", "ssm_out_norm")
_SSM_FP32 = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _convert(tree, path, *, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), dtype=dtype, device=device)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    keep32 = (any(name in _NORMS for name in path)
              or ("ssm" in path and path[-1] in _SSM_FP32))
    t = torch.tensor(arr)
    return t.to(device=device, dtype=torch.float32 if keep32 else dtype)


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None, dtype=None) -> Dict[str, Any]:
    """Reference param tree of numpy arrays -> port params on ``device``,
    weights in ``dtype`` (a torch dtype or its name; None: the activation
    dtype)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = (cfg.activation_dtype if dtype is None else dtype
          if isinstance(dtype, torch.dtype) else torch_dtype(dtype))
    dec = np_tree["decoder"]
    prologue = [_convert(lp, ("layers",), dtype=dt, device=dev)
                for lp in dec.get("prologue", ())]

    def layer(i, tree):
        if isinstance(tree, dict):
            return {k: layer(i, v) for k, v in tree.items()}
        return np.asarray(tree)[i]

    def unstack(scanned, n):
        return [_convert(layer(i, scanned), ("layers",), dtype=dt,
                         device=dev) for i in range(n)]

    out: Dict[str, Any] = {
        "embed": _convert(np_tree["embed"], ("embed",), dtype=dt, device=dev),
        "decoder": {"prologue": prologue,
                    "layers": unstack(dec["scanned"],
                                      cfg.num_layers - len(prologue))},
    }
    for name in ("final_norm", "lm_head", "frame_norm"):
        if name in np_tree:
            out[name] = _convert(np_tree[name], (name,), dtype=dt, device=dev)
    if cfg.is_encdec:
        enc = np_tree["encoder"]
        out["encoder"] = {
            "layers": unstack(enc["scanned"], cfg.encoder_layers),
            "final_norm": _convert(enc["final_norm"], ("final_norm",),
                                   dtype=dt, device=dev)}
    return out
