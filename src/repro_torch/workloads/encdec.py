"""Enc-dec serving engine of the port (``repro.workloads.encdec`` on one
device): full encode -> decode jobs, the fourth workload class.

An enc-dec job (seamless-m4t speech-to-text, say) has two phases with
opposite bound resources:

* **encode**: one bidirectional pass over the source.  The engine batches
  the encodes of every request admitted in the same step, one batch per
  source-length bucket (``ServeConfig.len_buckets``) and source kind, each
  row masking its own key padding (the flash kernel's ``kv_len``), so a
  job's encode does not depend on its bucket; the ladder is a live design
  knob (``apply(point=DesignPoint(buckets=...))``).  Encodes run eagerly,
  as prefills do;
* **decode**: the pooled-slot continuous batching of :class:`DecodeEngine`
  (CUDA graphs in the executable cache, pipelined dispatch, paged
  admission, preemption, resize, evacuation and adoption), where each step
  also reads the slot's **cross-attention source cache**: per layer (slots,
  max_src, kv_heads, head_dim) K/V written once at admission, read by the
  ragged decode kernel up to a static source bound and masked per row at
  the slot's ``src_len``.  The source bound joins the KV bound in each
  decode graph's key.

On a mesh under ``rules`` (the decode engine's tensor parallelism) the
encoder, the decoder and the cross-attention run on each rank's heads:
the batched encode's output is whole on every rank, each rank writes the
cross K/V of its own KV heads into its shard of the cross cache, and the
decode steps' cross-attention reads it on the rank's heads, summed over
the model group as the self-attention is.  Admission counts whole-model
rows, so every degree admits the same requests.

``submit(source, max_new_tokens, prefix=...)``: ``source`` is int token
ids (embedded as stand-in frames: the audio frontend is a stub) or a float
(S, d_model) array of precomputed frame embeddings; ``prefix`` forces
decoding, the decoder prompt becoming ``[bos] + prefix``.  A request holds
``src_len + len(decoder prompt) + max_new_tokens`` arena rows (cross K/V
and decoder KV have the same per-row footprint), so admission backpressures
on source-cache pressure as it does on KV pressure.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dse import DesignPoint
from repro_torch.distribution.partitioning import ShardingRules
from repro_torch.models.model import Model
from repro_torch.obs import Telemetry
from repro_torch.workloads.base import (ENCDEC, explicit_read, length_buckets,
                                        pick_bucket)
from repro_torch.workloads.compile_cache import ExecutableCache
from repro_torch.workloads.decode import (DecodeEngine, Request, ServeConfig,
                                          _PLACEHOLDER, _Pool, _round_block,
                                          _slot_view, _tree_map, _write_slot)

# source kinds a batched encode groups by: token ids embedded as stand-in
# frames (frontend stub) or precomputed frame embeddings
TOKENS, FRAMES = "tokens", "frames"


class EncDecEngine(DecodeEngine):
    """Encode -> decode serving of enc-dec archs (the ``encdec`` workload
    class): batched bucketed source encodes at admission, a per-slot
    cross-attention source cache, forced decoding from target prefixes,
    and the decode engine's pooled-slot decode."""

    workload_class = ENCDEC

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 exec_cache: Optional[ExecutableCache] = None,
                 obs: Optional[Telemetry] = None, mesh=None,
                 rules: Optional[ShardingRules] = None):
        mc = model.cfg
        if not (mc.is_encdec and mc.cross_attention):
            raise ValueError(
                f"EncDecEngine serves encoder-decoder archs with "
                f"cross-attention; {mc.name!r} is family={mc.family!r} "
                "(use DecodeEngine/SSMEngine for decoder-only archs, or "
                "EncoderEngine for embedding-only traffic)")
        # the source capacity and ladder shape the pool and the config key,
        # which the base constructor builds
        self._max_src = cfg.max_src_len or cfg.max_len
        self._src_buckets = length_buckets(cfg.len_buckets, self._max_src)
        self._bucket_hits: Dict[int, int] = {b: 0 for b in self._src_buckets}
        # decoder-prompt lengths (1: BOS alone) and source kinds seen bound
        # what warm_compile builds
        self._dec_lens = {1}
        self._src_kinds = {TOKENS}
        super().__init__(model, params, cfg, exec_cache=exec_cache, obs=obs,
                         mesh=mesh, rules=rules)
        # the base engine's token-bucketed prefills never run here
        self._prefill_lens = set()

    # ------------------------------------------------------------------
    # cache shapes and admission accounting (hooks of DecodeEngine)
    # ------------------------------------------------------------------
    def _config_key(self, slots: int, buckets=None) -> Tuple:
        """The source capacity and bucket ladder shape enc-dec steps too;
        ``buckets`` prices a candidate ladder."""
        ladder = (length_buckets(buckets, self._max_src)
                  if buckets is not None else self._src_buckets)
        return super()._config_key(slots) + (self._max_src, ladder)

    def _init_cache(self, slots: int, device=None):
        """Decoder KV plus the cross cache (per layer (slots, max_src,
        kv_heads, head_dim) K/V) and the per-slot ``src_len``."""
        return self.model.init_cache(slots, self.cfg.max_len,
                                     src_len=self._max_src, device=device)

    def _cache_specs(self, slots: int):
        return self.model.cache_logical_specs(slots, self.cfg.max_len,
                                              src_len=self._max_src)

    def _arena_capacity(self) -> int:
        """Per slot, ``max_len`` decoder-KV rows plus ``max_src`` source
        rows (the same per-layer row footprint)."""
        return (self.cfg.max_slots * (self.cfg.max_len + self._max_src)
                * self._per_token_elems)

    def _dec_prompt(self, req: Request) -> np.ndarray:
        """The decoder prompt: BOS, then the forced-decoding prefix."""
        bos = np.asarray([self.cfg.bos_id], np.int32)
        if req.prefix is None or len(req.prefix) == 0:
            return bos
        return np.concatenate([bos, np.asarray(req.prefix, np.int32)])

    def _slot_rows(self, req: Request) -> int:
        """Source frames plus decoder prompt plus generation budget."""
        return (len(req.tokens) + len(self._dec_prompt(req))
                + req.max_new_tokens)

    def _row_cap(self) -> int:
        return self.cfg.max_len + self._max_src

    def _live_rows(self, req: Request) -> int:
        """Paged coverage for the next dispatch: the whole source (written
        at admission) plus the live decoder KV and the row it writes."""
        return min(len(req.tokens) + self._dec_len(req) + 1, self._row_cap())

    def _oversized(self, req: Request) -> bool:
        """A source longer than the cross cache, or a decoder prompt plus
        budget longer than a slot."""
        return (len(req.tokens) > self._max_src
                or len(self._dec_prompt(req)) + req.max_new_tokens
                > self.cfg.max_len)

    def _dec_bucket(self, length: int) -> int:
        """Padded decoder-prompt length: 1 for BOS alone, else the prefill
        bucket (clamped to the slot)."""
        if length <= 1:
            return 1
        return min(self._bucketed(length), self.cfg.max_len)

    # ------------------------------------------------------------------
    # decode bounds: the decoder KV and the cross cache each get one
    # ------------------------------------------------------------------
    def _dec_len(self, req: Request) -> int:
        """Decoder-KV occupancy for the next dispatch: [bos] + prefix plus
        the tokens scheduled, not the source."""
        return len(self._dec_prompt(req)) + req.scheduled

    def _src_bound(self) -> int:
        longest = max((len(r.tokens) for r in self._active.values()),
                      default=1)
        return min(_round_block(longest), self._max_src)

    def _decode_bounds(self) -> Tuple[int, ...]:
        if not self.cfg.use_kernels:
            return ()
        return (self._kv_bound(), self._src_bound())

    def _full_bounds(self) -> Tuple[int, ...]:
        if not self.cfg.use_kernels:
            return ()
        return (self.cfg.max_len, self._max_src)

    # ------------------------------------------------------------------
    # executable-cache entries: batched bucketed encodes and per-slot
    # prefills, eager closures (decode graphs are the base engine's)
    # ------------------------------------------------------------------
    def _build_encode(self, sb: int, kind: str = TOKENS):
        """A batched encode of right-padded sources at bucket ``sb``:
        (E, sb) token ids or (E, sb, d) frames plus (E,) valid lengths ->
        (E, sb, d) encoder states."""
        del sb
        use_kernels = self.cfg.use_kernels

        def encode(src, lens):
            batch = {"frames": src} if kind == FRAMES else {"tokens": src}
            return self.model.encode(self.params, batch, lens=lens,
                                     use_kernels=use_kernels, tp=self._shard)
        return encode

    def _build_prefill_encdec(self, pool: _Pool, sb: int, nb: int):
        """A slot prefill into ``pool`` from row ``idx`` of an encode at
        bucket ``sb``, over a decoder prompt padded to ``nb``."""
        del sb, nb

        def prefill(enc, idx: int, src_len: int, slot: int, dec_toks,
                    dec_len: int):
            return self._encdec_prefill_fn(pool, enc, idx, src_len, slot,
                                           dec_toks, dec_len)
        return prefill

    def _encdec_prefill_fn(self, pool: _Pool, enc, idx: int, src_len: int,
                           slot: int, dec_toks, dec_len: int):
        """Write one encoded job into its slot, zeroed first: its row of
        the batched encode becomes the slot's cross K/V (masked at
        ``src_len``), and the decoder prompt's prefill seeds the slot's KV
        and the first generated token (on the device)."""
        view = _slot_view(pool.cache, pool.axes, slot)
        _tree_map(lambda ax, t: t.zero_() if ax >= 0 else None,
                  pool.axes, view)
        logits, filled = self.model.prefill(
            pool.params, {"tokens": dec_toks}, view, true_len=dec_len,
            use_kernels=self.cfg.use_kernels, enc_out=enc[idx:idx + 1],
            src_len=src_len, tp=pool.shard)
        _write_slot(pool.cache, filled, slot, pool.axes)
        return self.model.greedy(logits, pool.shard)[0]

    def _encode_exec(self, sb: int, kind: str = TOKENS):
        key = ("encdec_encode", self._cfg_key + (self._mesh_fp,), sb, kind)
        self._src_kinds.add(kind)
        return self._exec.get_or_build(
            key, self._counted(lambda: self._build_encode(sb, kind)))

    def _prefill_exec_encdec(self, sb: int, nb: int):
        pool = self._pool
        key = ("encdec_prefill", self._cfg_key + (pool.fp,), pool.gen, sb,
               nb)
        self._dec_lens.add(nb)
        return self._exec.get_or_build(
            key, self._counted(
                lambda: self._build_prefill_encdec(pool, sb, nb)))

    def warm_compile(self, sub, point: Optional[DesignPoint] = None) -> int:
        """Build decode steps at the bounds about to dispatch, one block
        above and at full capacity, and every (bucket, source kind,
        decoder-prompt length) encode and prefill entry, for the current
        design point or a candidate one.  Returns the builds performed."""
        point = point if point is not None else DesignPoint(cus=0)
        mesh = self._candidate_mesh(sub, point)
        moved = self._params_for(mesh)
        with self._lock, self._on_stream(), \
                self._obs.timed("warm_compile", "warm_compile_s") as sp:
            E = point.slots or self.cfg.max_slots
            pool = self._pool_for(E, mesh, live=False, moved=moved)
            key = self._config_key(E, point.buckets)
            ladder = (length_buckets(point.buckets, self._max_src)
                      if point.buckets is not None else self._src_buckets)
            built = 0
            for bounds in sorted({self._decode_bounds(), self._next_bounds(),
                                  self._full_bounds()}):
                built += self._exec.ensure(
                    self._decode_key(pool, key, bounds),
                    self._counted(lambda bounds=bounds:
                                  self._build_decode(pool, bounds)))
            # snapshots: the serving thread may add kinds or lengths while
            # a background prewarm iterates
            kinds = sorted(self._src_kinds)
            dec_lens = sorted(self._dec_lens)
            for sb in ladder:
                for kind in kinds:
                    built += self._exec.ensure(
                        ("encdec_encode", key + (pool.fp,), sb, kind),
                        self._counted(lambda sb=sb, kind=kind:
                                      self._build_encode(sb, kind)))
                for nb in dec_lens:
                    built += self._exec.ensure(
                        ("encdec_prefill", key + (pool.fp,), pool.gen, sb,
                         nb),
                        self._counted(lambda sb=sb, nb=nb:
                                      self._build_prefill_encdec(
                                          pool, sb, nb)))
            if sp is not None:
                sp["builds"] = built
        return built

    # ------------------------------------------------------------------
    # design-point knobs (serving DSE Stage 1)
    # ------------------------------------------------------------------
    def design(self) -> Dict[str, Any]:
        out = super().design()
        out["buckets"] = self._src_buckets
        return out

    def _apply_buckets(self, buckets):
        """Swap the source-length ladder live: encodes mask their key
        padding, so a job's stream is the same in any bucket."""
        if buckets is None:
            return None
        ladder = length_buckets(buckets, self._max_src)
        if ladder == self._src_buckets:
            return None
        self._src_buckets = ladder
        self._bucket_hits = {b: self._bucket_hits.get(b, 0) for b in ladder}
        self._cfg_key = self._config_key(self.cfg.max_slots)
        return ladder

    # ------------------------------------------------------------------
    # work ingestion
    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16, *,
               prefix=None) -> int:
        """Queue one encode -> decode job; returns its rid.  ``tokens`` is
        the source: int token ids or a float (S, d_model) array of frame
        embeddings; ``prefix`` forces decoding after BOS.  Oversized jobs
        are rejected but recorded."""
        rid = self._next_rid
        self._next_rid += 1
        src = np.asarray(tokens)
        if src.ndim == 2:                      # precomputed frame embeddings
            src = src.astype(np.float32)
        else:
            src = src.astype(np.int32)
        pre = None
        if prefix is not None and len(prefix) > 0:
            pre = np.asarray(prefix, np.int32)
        self._recent_lens.append(len(src))
        self._queue.append(Request(rid, src, max_new_tokens, prefix=pre,
                                   submitted_s=time.perf_counter()))
        self._obs.inc("requests_submitted")
        return rid

    # ------------------------------------------------------------------
    # admission: one batched encode per (bucket, kind) group, then the
    # slot prefills
    # ------------------------------------------------------------------
    def _prefill_admitted(self, reqs: List[Request]) -> None:
        by_group: Dict[Tuple[int, str], List[Request]] = {}
        for req in reqs:
            kind = FRAMES if req.tokens.ndim == 2 else TOKENS
            sb = pick_bucket(self._src_buckets, len(req.tokens))
            by_group.setdefault((sb, kind), []).append(req)
        E = self.cfg.max_slots
        d = self.model.cfg.d_model
        for sb, kind in sorted(by_group):
            group = by_group[(sb, kind)]
            for at in range(0, len(group), E):
                chunk = group[at:at + E]
                if kind == FRAMES:
                    src = np.zeros((E, sb, d), np.float32)
                else:
                    src = np.zeros((E, sb), np.int32)
                lens = np.zeros((E,), np.int32)
                for i, req in enumerate(chunk):
                    src[i, :len(req.tokens)] = req.tokens
                    lens[i] = len(req.tokens)
                # the encode syncs at the first prefill's token read, so
                # this span times its dispatch
                with self._obs.span("encode", bucket=sb, kind=kind,
                                    n=len(chunk)), self._on_stream():
                    enc = self._encode_exec(sb, kind)
                    if self._member:        # a rank outside the mesh: none
                        enc = enc(self._to_device(src),
                                  self._to_device(lens))
                for i, req in enumerate(chunk):
                    self._bucket_hits[sb] += 1
                    dec = self._dec_prompt(req)
                    nb = self._dec_bucket(len(dec))
                    toks = np.zeros((1, nb), np.int32)
                    toks[0, :len(dec)] = dec
                    with self._obs.timed("prefill", "prefill_s",
                                         src=len(req.tokens)), \
                            self._on_stream():
                        exe = self._prefill_exec_encdec(sb, nb)
                        first = _PLACEHOLDER
                        if self._member:
                            first_dev = exe(enc, i, len(req.tokens),
                                            req.slot, self._to_device(toks),
                                            len(dec))
                            with explicit_read():
                                first = int(first_dev.cpu())  # first token
                    first = self._eos_token(first)
                    req.out_tokens.append(first)
                    req.scheduled = 1
                    self._inject[req.slot] = first
                    self._record_ttft(req)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The decode engine's stats plus jobs served per source bucket."""
        out = super().stats()
        out["bucket_hits"] = {str(b): n for b, n in self._bucket_hits.items()}
        return out
