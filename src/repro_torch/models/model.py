"""Model facade of the port (``repro.models.model``, decoder-only serving).

``Model(cfg, device)`` gives ``init(generator)``, ``init_cache``,
``prefill`` and ``decode_step`` over plain parameter dicts, for dense GQA
and attention-free Mamba decoders.  Weights are cast once, at load, to the
activation dtype: the same values as the reference's per-use
``.astype(x.dtype)`` at half the memory of fp32.  Norm parameters and the
Mamba block's conv_w, conv_b, dt_bias, A_log and D stay fp32, as the
reference computes with them in fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PyTree = Any


class Model:
    """Decoder-only model (dense GQA or attention-free Mamba) on one
    device."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> PyTree:
        """Random weights from ``generator`` (on this model's device), in
        the activation dtype, with the reference's init scales."""
        cfg, dev = self.cfg, self.device
        dt = cfg.activation_dtype
        std = cfg.d_model ** -0.5

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=dt,
                               device=dev) * std

        params: Dict[str, PyTree] = {
            "embed": normal((cfg.padded_vocab, cfg.d_model)),
            "decoder": T.decoder_init(generator, cfg, dtype=dt, device=dev),
            "final_norm": T.norm_init(cfg.norm, cfg.d_model, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((cfg.d_model, cfg.padded_vocab))
        return params

    # ------------------------------------------------------------------
    def _head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _mask_pad(self, logits):
        """-1e30 on vocab-padding columns so sampling never emits them."""
        V = self.cfg.vocab_size
        if logits.shape[-1] == V:
            return logits
        ok = torch.arange(logits.shape[-1], device=logits.device) < V
        return torch.where(ok, logits, torch.full_like(logits, -1e30))

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.cfg.activation_dtype)

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int):
        """Pooled decode cache for ``batch`` slots of ``max_len`` tokens."""
        return T.decoder_cache_init(self.cfg, batch, max_len,
                                    self.cfg.activation_dtype, self.device)

    @staticmethod
    def cache_slot_axes(cache):
        return T.cache_slot_axes(cache)

    @torch.no_grad()
    def prefill(self, params, batch, cache, *, true_len=None,
                use_kernels: bool = True):
        """Run the prompt, writing its K/V into ``cache`` in place.

        true_len: optional scalar or (B,) valid prompt lengths of a
        right-padded prompt.  Returns the logits at the last valid position
        per row and the cache with per-row positions."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos = torch.arange(S, device=x.device).expand(B, S)
        x, cache = T.decoder_prefill(params["decoder"], cfg, x, pos, cache,
                                     true_len=true_len,
                                     use_kernels=use_kernels)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        rows = torch.arange(B, device=x.device)
        if true_len is None:
            last = x[:, -1]
        else:
            idx = torch.as_tensor(true_len, device=x.device).expand(B) - 1
            last = x[rows, idx.long()]
        logits = self._mask_pad(last @ self._head(params))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, *, use_kernels: bool = False,
                    kv_bound: Optional[int] = None, live_mask=None):
        """tokens: (B, 1) -> (logits (B, V), cache).  With ``use_kernels``
        decode attention reads only the ``kv_bound`` prefix and skips slots
        whose ``live_mask`` is false."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        x, cache = T.decoder_step(params["decoder"], cfg, x, cache,
                                  use_kernels=use_kernels, kv_bound=kv_bound,
                                  live=live_mask)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        logits = self._mask_pad(x[:, 0] @ self._head(params))
        return logits, cache


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg, device)
