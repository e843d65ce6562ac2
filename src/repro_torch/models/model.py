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
layers' load-balance loss, for every registered family: decoder-only
archs with GQA or MLA attention and dense or MoE FFNs (minitron, qwen2.5,
granite, chameleon, qwen1.5, deepseek-v2-lite, arctic), attention-free
Mamba (falcon-mamba), hybrid (hymba: sliding-window attention beside
Mamba), and the encoder-decoder (seamless-m4t: the encoder over
``batch["frames"]``, of any length, and the decoder's cross-attention
over its output).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distribution import partitioning as part
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PyTree = Any


class Model:
    """Decoder-only model (dense or MoE, GQA or MLA, attention-free Mamba
    or hybrid) or dense encoder-decoder on one device."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        T.check_supported(cfg)
        self.cfg = cfg
        # "meta": shapes without data, the dry run's (launch/dryrun.py)
        meta = device is not None and torch.device(device).type == "meta"
        self.device = torch.device("meta") if meta else resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=None,
             place=None) -> PyTree:
        """Random weights from ``generator`` (on this model's device), with
        the reference's init scales, in ``dtype`` (a torch dtype or its
        name, as ``cfg.param_dtype``; None: the activation dtype, for
        serving).  ``place(tensor, logical_spec)``, where given, maps each
        leaf as soon as its layer is drawn (a mesh keeps its local shard),
        so that no more than one layer's full leaves exist at a time; the
        draws are the same either way."""
        cfg, dev = self.cfg, self.device
        dt = (cfg.activation_dtype if dtype is None else dtype
              if isinstance(dtype, torch.dtype) else torch_dtype(dtype))
        std = cfg.d_model ** -0.5
        specs = self.logical_specs()

        def normal(name, shape):
            t = torch.randn(shape, generator=generator, dtype=dt,
                            device=dev) * std
            return t if place is None else place(t, specs[name])

        def norm(name):
            p = T.norm_init(cfg.norm, cfg.d_model, dev)
            return T.placed(p, specs[name], place)

        params: Dict[str, PyTree] = {
            "embed": normal("embed", (cfg.padded_vocab, cfg.d_model)),
            "decoder": T.decoder_init(generator, cfg, dtype=dt, device=dev,
                                      place=place),
            "final_norm": norm("final_norm"),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal("lm_head",
                                       (cfg.d_model, cfg.padded_vocab))
        if cfg.is_encdec:
            params["encoder"] = T.encoder_init(generator, cfg, dtype=dt,
                                               device=dev, place=place)
            if cfg.frontend == "frames":
                params["frame_norm"] = norm("frame_norm")
        return params

    def logical_specs(self) -> PyTree:
        """The logical spec of every leaf of ``init``'s tree, in its
        structure: the reference's annotations, where a scanned layer's
        leaf drops the leading "layers" axis (the port keeps a list)."""
        cfg = self.cfg
        specs: Dict[str, PyTree] = {
            "embed": ("vocab", "embed"),
            "decoder": T.decoder_specs(cfg),
            "final_norm": T.norm_specs(cfg.norm),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("embed", "vocab")
        if cfg.is_encdec:
            specs["encoder"] = T.encoder_specs(cfg)
            if cfg.frontend == "frames":
                specs["frame_norm"] = T.norm_specs(cfg.norm)
        return specs

    # ------------------------------------------------------------------
    def _head(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _vocab_offset(self, local: int, tp) -> int:
        """The first vocab id of this rank's columns: 0 unless the vocab is
        split over a tensor-parallel mesh's model dim."""
        if tp is None or local == self.cfg.padded_vocab:
            return 0
        return tp.index * local

    def _mask_pad(self, logits, tp=None):
        """-1e30 on vocab-padding columns so sampling never emits them."""
        V = self.cfg.vocab_size
        off = self._vocab_offset(logits.shape[-1], tp)
        if off + logits.shape[-1] <= V:
            return logits
        ok = torch.arange(logits.shape[-1], device=logits.device) + off < V
        return torch.where(ok, logits, torch.full_like(logits, -1e30))

    def _embed(self, params, tokens, tp=None):
        """Token embeddings.  A vocab-split table (tensor-parallel serving)
        looks up the ids in this rank's rows, zero elsewhere, and sums over
        the model group: one row per token crosses the group, never the
        table."""
        table = params["embed"]
        if part.is_dtensor(table):          # a mesh: each rank's rows
            return part.lookup(table, tokens).to(self.cfg.activation_dtype)
        off = self._vocab_offset(table.shape[0], tp)
        if not off and table.shape[0] == self.cfg.padded_vocab:
            return table[tokens.long()].to(self.cfg.activation_dtype)
        idx = tokens.long() - off
        mine = (idx >= 0) & (idx < table.shape[0])
        rows = table[idx.clamp(0, table.shape[0] - 1)]
        x = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return tp.all_reduce(x.to(self.cfg.activation_dtype))

    def greedy(self, logits, tp=None):
        """The argmax of each row of ``logits`` (B, V) as int32, the first
        id on ties.  Vocab-split logits: each rank's first maximum, the
        (value, id) pairs gathered over the model group, and the maximum
        of the rank that holds the lowest ids among those tied."""
        idx = torch.argmax(logits, dim=-1)
        if tp is None or logits.shape[-1] == self.cfg.padded_vocab:
            return idx.to(torch.int32)
        off = self._vocab_offset(logits.shape[-1], tp)
        val = logits.gather(-1, idx[:, None])[:, 0].float()
        pair = torch.stack([val, (idx + off).float()], dim=0)   # (2, B)
        every = tp.all_gather(pair[None], 0)                    # (n, 2, B)
        best = torch.argmax(every[:, 0], dim=0)                 # first rank
        return every[best, 1, torch.arange(best.shape[0],
                                           device=best.device)].to(
            torch.int32)

    def gather_logits(self, logits, tp=None):
        """Vocab-split logits gathered whole on every rank of the group."""
        if tp is None or logits.shape[-1] == self.cfg.padded_vocab:
            return logits
        return tp.all_gather(logits, -1)

    def _encode(self, params, frames, src_len=None, use_kernels: bool = True,
                remat: bool = False, tp=None):
        """Bidirectional encoder over frame embeddings (B, S, d); src_len:
        optional (B,) int32 valid frame counts of right-padded rows;
        ``remat``: per-layer checkpoints under autograd (training); ``tp``:
        this rank's shards on a tensor-parallel mesh (the output is whole
        on every rank)."""
        cfg = self.cfg
        x = L.apply_norm(cfg.norm, params["frame_norm"],
                         frames.to(cfg.activation_dtype), cfg.norm_eps)
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S, device=x.device).expand(B, S)
        return T.encoder_fwd(params["encoder"], cfg, x, pos, kv_len=src_len,
                             use_kernels=use_kernels, remat=remat, tp=tp)

    # ------------------------------------------------------------------
    def loss(self, params, batch, *, use_kernels: bool = True,
             moe_dispatch: str = "einsum", aux_weight: float = 0.01,
             residual_spec=None):
        """batch: {tokens, labels} (B, S) int, and for enc-dec archs
        frames (B, S_src, d) -> (xent + aux_weight * aux, {"xent", "aux"}).

        Labels below 0 are masked out.  ``aux`` is the MoE layers'
        load-balance loss summed over the layers (0 for dense archs).  An
        enc-dec arch encodes the frames (any S_src) and its decoder's
        cross layers attend the encoder output.  The encoder and the
        decoder run with per-layer remat when ``cfg.remat``; the
        cross-entropy is chunked (``transformer.chunked_softmax_xent``).
        ``use_kernels``: attention through the flash kernels and their
        backward, and the Mamba blocks' scan through the scan kernel with
        its boundary states and the scan's backward kernel, on the card
        (the plain versions on a CPU tensor either way); ``moe_dispatch``: "einsum" (the reference's default) or
        "gather".  ``residual_spec``: the decoder's residual layout on a
        mesh (``transformer.decoder_fwd``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        pos = torch.arange(S, device=x.device).expand(B, S)
        enc_out = None
        if cfg.is_encdec:
            enc_out = self._encode(params, batch["frames"],
                                   use_kernels=use_kernels, remat=cfg.remat)
        x, aux = T.decoder_fwd(params["decoder"], cfg, x, pos,
                               use_kernels=use_kernels,
                               moe_dispatch=moe_dispatch, remat=cfg.remat,
                               enc_out=enc_out, residual_spec=residual_spec)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        xent = T.chunked_softmax_xent(x, self._head(params),
                                      torch.clamp(labels, min=0), mask,
                                      logit_softcap=cfg.logit_softcap)
        return xent + aux_weight * aux, {"xent": xent, "aux": aux}

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, src_len: int = 0,
                   device: DeviceLike = None):
        """Pooled decode cache for ``batch`` slots of ``max_len`` tokens
        (on ``device``, this model's by default; "meta" gives the shapes).
        src_len: the cross cache's source capacity (enc-dec archs), with a
        per-slot ``src_len`` int32 vector of valid source lengths."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        cache = T.decoder_cache_init(
            cfg, batch, max_len, cfg.activation_dtype, dev,
            cross_src=src_len if cfg.is_encdec else 0)
        if cfg.is_encdec:
            cache["src_len"] = torch.full((batch,), src_len,
                                          dtype=torch.int32, device=dev)
        return cache

    def cache_logical_specs(self, batch: int, max_len: int, *,
                            src_len: int = 0) -> PyTree:
        """The logical spec of every leaf of ``init_cache``'s tree, in its
        structure (the reference's cache annotations): KV (batch, kv_seq,
        kv_heads, None), a stacked leaf with a leading "layers" axis."""
        del batch, max_len
        cfg = self.cfg
        specs = T.decoder_cache_specs(
            cfg, cross_src=src_len if cfg.is_encdec else 0)
        if cfg.is_encdec:
            specs["src_len"] = ("batch",)
        return specs

    @staticmethod
    def cache_slot_axes(cache):
        return T.cache_slot_axes(cache)

    @torch.no_grad()
    def prefill(self, params, batch, cache, *, true_len=None,
                use_kernels: bool = True, enc_out=None, src_len=None,
                moe_dispatch: str = "einsum", tp=None):
        """Run the prompt, writing its K/V into ``cache`` in place.

        true_len: optional scalar or (B,) valid prompt lengths of a
        right-padded prompt.  Returns the logits at the last valid position
        per row and the cache with per-row positions.

        Enc-dec archs also take ``enc_out``, encoder hidden states (B,
        S_src, d) computed apart (else ``batch["frames"]`` is encoded
        here), and ``src_len``, a scalar or (B,) valid source lengths of a
        right-padded ``enc_out``: it masks the cross-attention and is
        recorded in the returned cache's ``src_len``.  ``moe_dispatch``
        selects the MoE layers' dispatch, "einsum" or "gather".  ``tp`` (a
        ``partitioning.TPShard``): this rank's local shards on a
        tensor-parallel mesh (heads, cross-attention heads, Mamba channels,
        experts, FFN widths; ``transformer.decoder_prefill``); the logits
        are then this rank's vocab columns where the vocab is split
        (``greedy``, ``gather_logits``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens, tp)
        pos = torch.arange(S, device=x.device).expand(B, S)
        if cfg.is_encdec and enc_out is None:
            enc_out = self._encode(params, batch["frames"],
                                   use_kernels=use_kernels, tp=tp)
        x, cache = T.decoder_prefill(params["decoder"], cfg, x, pos, cache,
                                     true_len=true_len,
                                     use_kernels=use_kernels,
                                     enc_out=enc_out, src_len=src_len,
                                     moe_dispatch=moe_dispatch, tp=tp)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        rows = torch.arange(B, device=x.device)
        if true_len is None:
            last = x[:, -1]
        else:
            idx = torch.as_tensor(true_len, device=x.device).expand(B) - 1
            last = x[rows, idx.long()]
        logits = self._mask_pad(last @ self._head(params), tp)
        if cfg.is_encdec:
            src = enc_out.shape[1] if src_len is None else src_len
            cache["src_len"] = torch.as_tensor(
                src, dtype=torch.int32, device=x.device).expand(B).clone()
        return logits, cache

    @torch.no_grad()
    def encode(self, params, batch, *, lens=None, use_kernels: bool = True,
               tp=None):
        """Full-sequence hidden states (B, S, d) for embedding workloads:
        no cache, no decode loop.

        Enc-dec archs run the bidirectional encoder over ``frames`` when
        given, else over the token embeddings (the frontend stub), and
        ``lens`` (optional (B,) int32 valid lengths of right-padded rows)
        masks each row's key padding.  Decoder-only archs run the causal
        decoder stack and its final norm; causal rows do not see their
        padding, so ``lens`` is not needed there.  ``tp``: as in
        ``prefill``; the token lookup is ``_embed``'s (a vocab-split table
        looks up its own rows and sums over the group), and the hidden
        states come out whole on every rank."""
        cfg = self.cfg
        if cfg.is_encdec:
            frames = batch.get("frames")
            if frames is None:
                frames = self._embed(params, batch["tokens"], tp)
            return self._encode(params, frames, src_len=lens,
                                use_kernels=use_kernels, tp=tp)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens, tp)
        pos = torch.arange(S, device=x.device).expand(B, S)
        x, _ = T.decoder_fwd(params["decoder"], cfg, x, pos,
                             use_kernels=use_kernels, tp=tp)
        return L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, *, use_kernels: bool = False,
                    kv_bound: Optional[int] = None,
                    src_bound: Optional[int] = None, live_mask=None,
                    moe_dispatch: str = "einsum", tp=None):
        """tokens: (B, 1) -> (logits (B, V), cache).  With ``use_kernels``
        decode attention reads only the ``kv_bound`` prefix (cross-attention
        the ``src_bound`` prefix) and skips slots whose ``live_mask`` is
        false.  ``moe_dispatch`` and ``tp`` as in ``prefill``."""
        cfg = self.cfg
        x = self._embed(params, tokens, tp)
        x, cache = T.decoder_step(params["decoder"], cfg, x, cache,
                                  use_kernels=use_kernels, kv_bound=kv_bound,
                                  live=live_mask, src_len=cache.get("src_len"),
                                  src_bound=src_bound,
                                  moe_dispatch=moe_dispatch, tp=tp)
        x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        logits = self._mask_pad(x[:, 0] @ self._head(params), tp)
        return logits, cache


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg, device)
