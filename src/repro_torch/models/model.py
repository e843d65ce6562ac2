"""Model facade of the port (``repro.models.model``, serving).

``Model(cfg, device)`` gives ``init(generator)``, ``init_cache``,
``prefill``, ``decode_step`` and ``encode`` over plain parameter dicts,
for dense and MoE decoders (GQA or MLA attention, with DeepSeek's
first-k-dense prologue), attention-free Mamba decoders, hybrid decoders
(attention beside Mamba in every layer) and dense GQA encoder-decoders (whose audio frontend is a stub: token embeddings or
precomputed frame embeddings enter the encoder through ``frame_norm``).
For serving, weights are cast once, at load, to the
activation dtype: the same values as the reference's per-use
``.astype(x.dtype)`` at half the memory of fp32.  Norm parameters and the
Mamba block's conv_w, conv_b, dt_bias, A_log and D stay fp32, as the
reference computes with them in fp32.  Training keeps fp32 masters
(``init(generator, dtype=cfg.param_dtype)``), which the layers cast to the
activation dtype at use, as the reference does.

``loss(params, batch)`` is the training objective, the reference's
``Model.loss``: the cross-entropy plus ``aux_weight`` times the MoE
layers' load-balance loss, for decoder-only archs with GQA or MLA
attention and dense or MoE FFNs (minitron, qwen2.5, granite, chameleon,
qwen1.5, deepseek-v2-lite, arctic), attention-free Mamba (falcon-mamba)
and hybrid (hymba: sliding-window attention beside Mamba); enc-dec archs
raise, naming the ROADMAP item that brings their training.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PyTree = Any


class Model:
    """Decoder-only model (dense or MoE, GQA or MLA, attention-free Mamba
    or hybrid) or dense encoder-decoder on one device."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=None) -> PyTree:
        """Random weights from ``generator`` (on this model's device), with
        the reference's init scales, in ``dtype`` (a torch dtype or its
        name, as ``cfg.param_dtype``; None: the activation dtype, for
        serving)."""
        cfg, dev = self.cfg, self.device
        dt = (cfg.activation_dtype if dtype is None else dtype
              if isinstance(dtype, torch.dtype) else torch_dtype(dtype))
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
        if cfg.is_encdec:
            params["encoder"] = T.encoder_init(generator, cfg, dtype=dt,
                                               device=dev)
            if cfg.frontend == "frames":
                params["frame_norm"] = T.norm_init(cfg.norm, cfg.d_model,
                                                   dev)
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

    def _encode(self, params, frames, src_len=None, use_kernels: bool = True):
        """Bidirectional encoder over frame embeddings (B, S, d); src_len:
        optional (B,) int32 valid frame counts of right-padded rows."""
        cfg = self.cfg
        x = L.apply_norm(cfg.norm, params["frame_norm"],
                         frames.to(cfg.activation_dtype), cfg.norm_eps)
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, device=x.device).expand(B, S)
        return T.encoder_fwd(params["encoder"], cfg, x, pos, kv_len=src_len,
                             use_kernels=use_kernels)

    # ------------------------------------------------------------------
    def loss(self, params, batch, *, use_kernels: bool = True,
             moe_dispatch: str = "einsum", aux_weight: float = 0.01):
        """batch: {tokens, labels} (B, S) int -> (xent + aux_weight * aux,
        {"xent", "aux"}).

        Labels below 0 are masked out.  ``aux`` is the MoE layers'
        load-balance loss summed over the layers (0 for dense archs).  The
        decoder runs with per-layer remat when ``cfg.remat``; the
        cross-entropy is chunked (``transformer.chunked_softmax_xent``).
        ``use_kernels``: attention through the flash kernels and their
        backward, and the Mamba blocks' scan through the scan kernel with
        its boundary states and the scan's backward kernel, on the card
        (the plain versions on a CPU tensor either way); ``moe_dispatch``: "einsum" (the reference's default) or
        "gather"."""
        cfg = self.cfg
        check_trainable(cfg)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos = torch.arange(S, device=x.device).expand(B, S)
        x, aux = T.decoder_fwd(params["decoder"], cfg, x, pos,
                               use_kernels=use_kernels,
                               moe_dispatch=moe_dispatch, remat=cfg.remat)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        xent = T.chunked_softmax_xent(x, self._head(params),
                                      torch.clamp(labels, min=0), mask,
                                      logit_softcap=cfg.logit_softcap)
        return xent + aux_weight * aux, {"xent": xent, "aux": aux}

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, src_len: int = 0):
        """Pooled decode cache for ``batch`` slots of ``max_len`` tokens.
        src_len: the cross cache's source capacity (enc-dec archs), with a
        per-slot ``src_len`` int32 vector of valid source lengths."""
        cfg = self.cfg
        cache = T.decoder_cache_init(
            cfg, batch, max_len, cfg.activation_dtype, self.device,
            cross_src=src_len if cfg.is_encdec else 0)
        if cfg.is_encdec:
            cache["src_len"] = torch.full((batch,), src_len,
                                          dtype=torch.int32,
                                          device=self.device)
        return cache

    @staticmethod
    def cache_slot_axes(cache):
        return T.cache_slot_axes(cache)

    @torch.no_grad()
    def prefill(self, params, batch, cache, *, true_len=None,
                use_kernels: bool = True, enc_out=None, src_len=None,
                moe_dispatch: str = "einsum"):
        """Run the prompt, writing its K/V into ``cache`` in place.

        true_len: optional scalar or (B,) valid prompt lengths of a
        right-padded prompt.  Returns the logits at the last valid position
        per row and the cache with per-row positions.

        Enc-dec archs also take ``enc_out``, encoder hidden states (B,
        S_src, d) computed apart (else ``batch["frames"]`` is encoded
        here), and ``src_len``, a scalar or (B,) valid source lengths of a
        right-padded ``enc_out``: it masks the cross-attention and is
        recorded in the returned cache's ``src_len``.  ``moe_dispatch``
        selects the MoE layers' dispatch, "einsum" or "gather"."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos = torch.arange(S, device=x.device).expand(B, S)
        if cfg.is_encdec and enc_out is None:
            enc_out = self._encode(params, batch["frames"],
                                   use_kernels=use_kernels)
        x, cache = T.decoder_prefill(params["decoder"], cfg, x, pos, cache,
                                     true_len=true_len,
                                     use_kernels=use_kernels,
                                     enc_out=enc_out, src_len=src_len,
                                     moe_dispatch=moe_dispatch)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        rows = torch.arange(B, device=x.device)
        if true_len is None:
            last = x[:, -1]
        else:
            idx = torch.as_tensor(true_len, device=x.device).expand(B) - 1
            last = x[rows, idx.long()]
        logits = self._mask_pad(last @ self._head(params))
        if cfg.is_encdec:
            src = enc_out.shape[1] if src_len is None else src_len
            cache["src_len"] = torch.as_tensor(
                src, dtype=torch.int32, device=x.device).expand(B).clone()
        return logits, cache

    @torch.no_grad()
    def encode(self, params, batch, *, lens=None, use_kernels: bool = True):
        """Full-sequence hidden states (B, S, d) for embedding workloads:
        no cache, no decode loop.

        Enc-dec archs run the bidirectional encoder over ``frames`` when
        given, else over the token embeddings (the frontend stub), and
        ``lens`` (optional (B,) int32 valid lengths of right-padded rows)
        masks each row's key padding.  Decoder-only archs run the causal
        decoder stack and its final norm; causal rows do not see their
        padding, so ``lens`` is not needed there."""
        cfg = self.cfg
        if cfg.is_encdec:
            frames = batch.get("frames")
            if frames is None:
                frames = params["embed"][batch["tokens"].long()]
            return self._encode(params, frames, src_len=lens,
                                use_kernels=use_kernels)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos = torch.arange(S, device=x.device).expand(B, S)
        x, _ = T.decoder_fwd(params["decoder"], cfg, x, pos,
                             use_kernels=use_kernels)
        return L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, *, use_kernels: bool = False,
                    kv_bound: Optional[int] = None,
                    src_bound: Optional[int] = None, live_mask=None,
                    moe_dispatch: str = "einsum"):
        """tokens: (B, 1) -> (logits (B, V), cache).  With ``use_kernels``
        decode attention reads only the ``kv_bound`` prefix (cross-attention
        the ``src_bound`` prefix) and skips slots whose ``live_mask`` is
        false.  ``moe_dispatch`` as in ``prefill``."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        x, cache = T.decoder_step(params["decoder"], cfg, x, cache,
                                  use_kernels=use_kernels, kv_bound=kv_bound,
                                  live=live_mask, src_len=cache.get("src_len"),
                                  src_bound=src_bound,
                                  moe_dispatch=moe_dispatch)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        logits = self._mask_pad(x[:, 0] @ self._head(params))
        return logits, cache


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for the families whose training the port does not have yet,
    naming the ROADMAP item that brings each: enc-dec."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the port trains decoder-only archs (GQA or MLA "
            f"attention, dense or MoE FFNs, attention-free Mamba and hybrid "
            f"attention beside Mamba); enc-dec training comes later "
            f"(ROADMAP queue 1, item 1 (c))")


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg, device)
