"""Transformer decode engine of the port (``repro.workloads.decode`` on one
device): continuous batching over a pooled slot cache, FlexArena or
PagedArena admission control, bucketed prefill into a slot, pipelined
decode dispatch, and paged preemption with exact resume.

Decode state on the device is the model's pooled cache (slot axis 1 on
the stacked KV tensors), updated in place: a prefill writes one slot, a
decode step advances every live slot in lock-step, and slots join and
leave between steps.

Pipelined dispatch: when termination is length-based (``eos_id < 0``),
step *k* is enqueued from the device-resident tokens of step *k-1* before
the host reads them; each step's tokens are copied to pinned host memory
behind an event, so the host's bookkeeping overlaps the device's work.
The two host syncs are the reference's two ``device_get`` points: the
first token of a prefill and the harvest of a decode step.

The reference's tensor parallelism, live slot resizing, dp-replica
migration and AOT executable cache belong to the fabric slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import (AllocationError, FlexArena, PagedArena,
                                    ROLE_ACT)
from repro_torch.models.model import Model
from repro_torch.obs import Telemetry
from repro_torch.workloads.base import (DECODE, DecayedLengthEstimator,
                                        EngineTelemetry)

PyTree = Any

# Decode attention reads cache[:, :kv_bound], the longest live row rounded
# up to this block, as in the reference's bounded decode programs.
KV_BOUND_BLOCK = 32


def _round_block(n: int) -> int:
    return -(-max(n, 1) // KV_BOUND_BLOCK) * KV_BOUND_BLOCK


@dataclasses.dataclass
class Request:
    """One submitted request's host-side lifecycle record."""

    rid: int
    tokens: np.ndarray                  # prompt
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    view: Any = None                    # arena view (admission accounting)
    done: bool = False
    # tokens scheduled for emission (prefill's first token + dispatched
    # decode steps); runs ahead of len(out_tokens) by the in-flight step
    scheduled: int = 0
    submitted_s: float = 0.0            # perf_counter() at submit


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Per-tenant serving dimensions."""

    max_slots: int = 4                 # concurrent decode slots
    max_len: int = 128                 # per-slot cache capacity (tokens)
    eos_id: int = 0
    prefill_bucket: int = 32           # prompts padded up to this length
    # overlap decode dispatch with host bookkeeping (when eos_id < 0)
    pipeline_decode: bool = True
    # hand-written attention kernels on the hot path: ragged decode
    # attention over the live KV prefix, flash attention in prefill
    use_kernels: bool = True
    # paged KV admission arena; kv_arena_frac scales the arena budget
    # against the dense per-slot worst case for both arena kinds
    paged_kv: bool = True
    kv_page_rows: int = 16             # rows (tokens) per page
    kv_arena_frac: float = 1.0         # arena budget / dense worst case


@dataclasses.dataclass
class _Inflight:
    """One dispatched decode step whose tokens the host hasn't read yet."""

    nxt: torch.Tensor                   # device (B,) int32
    host: torch.Tensor                  # host copy of nxt (pinned on CUDA)
    ready: Optional[torch.cuda.Event]   # set when the host copy landed
    entries: List[Tuple[int, Request, bool]]   # (slot, request, finishing)
    pipelined: bool


def _tree_map(fn: Callable, axes, *trees):
    """Map ``fn(axis, *leaves)`` over cache trees shaped like ``axes``."""
    if isinstance(axes, dict):
        return {k: _tree_map(fn, a, *(t[k] for t in trees))
                for k, a in axes.items()}
    if isinstance(axes, list):
        return [_tree_map(fn, a, *(t[i] for t in trees))
                for i, a in enumerate(axes)]
    return fn(axes, *trees)


def _slot_view(cache: PyTree, axes: PyTree, slot: int) -> PyTree:
    """One slot of the pooled cache as views (slot dim kept at size 1)."""
    return _tree_map(lambda ax, t: t if ax < 0 else t.narrow(ax, slot, 1),
                     axes, cache)


def _write_slot(pool: PyTree, block: PyTree, slot: int, axes: PyTree) -> None:
    """Copy a one-slot block into slot ``slot`` of the pool, in place."""
    def write(ax, dst, src):
        if ax < 0:
            return
        view = dst.narrow(ax, slot, 1)
        if src.data_ptr() != view.data_ptr() or src.device != view.device:
            view.copy_(src)

    _tree_map(write, axes, pool, block)


# fabriclint: disable=protocol -- single-device port: the fabric surface (reshard_to, apply, warm_compile, sync, design) belongs to the port's fabric slice
class DecodeEngine(EngineTelemetry):
    """Batched transformer decode on one device: continuous batching over
    a pooled slot cache, arena admission control, pipelined dispatch and
    preemption with exact resume."""

    workload_class = DECODE

    def __init__(self, model: Model, params: PyTree, cfg: ServeConfig,
                 obs: Optional[Telemetry] = None):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self._obs = obs if obs is not None else Telemetry()
        self._recent_lens = DecayedLengthEstimator()
        self._per_token_elems = self._per_token_cache_elems()
        self.arena = self._make_arena()
        self._queue: List[Request] = []
        self._active: Dict[int, Request] = {}
        # preempted requests parked host-side with their exported cache
        self._parked: List[Tuple[Request, PyTree]] = []
        self.preempt_count = 0
        self._finished: Dict[int, List[int]] = {}
        self.finished_cap = 10_000
        self._next_rid = 0
        self._free_slots = list(range(cfg.max_slots))
        self.params = params
        self.cache = model.init_cache(cfg.max_slots, cfg.max_len)
        self._slot_axes = model.cache_slot_axes(self.cache)
        self._inflight: Optional[_Inflight] = None
        self._inject: Dict[int, int] = {}   # slot -> token since last dispatch
        self._emit_buf: List[Tuple[int, int]] = []

    # ------------------------------------------------------------------
    # admission accounting
    # ------------------------------------------------------------------
    def _per_token_cache_elems(self) -> int:
        """Per-token KV elements over all layers (admission accounting);
        an attention-free arch holds no KV."""
        mc = self.model.cfg
        per_tok = (0 if mc.attention_free
                   else 2 * mc.num_kv_heads * mc.resolved_head_dim)
        return max(per_tok, 1) * mc.num_layers

    def _arena_capacity(self) -> int:
        return self.cfg.max_slots * self.cfg.max_len * self._per_token_elems

    def _slot_rows(self, req: Request) -> int:
        return len(req.tokens) + req.max_new_tokens

    def _row_cap(self) -> int:
        return self.cfg.max_len

    def _page_rows(self) -> int:
        return max(1, min(self.cfg.kv_page_rows, self._row_cap()))

    def _arena_pages(self) -> int:
        """Page budget: the dense worst case scaled by ``kv_arena_frac``,
        floored at one slot's worth so a lone request always fits."""
        per_slot = -(-self._row_cap() // self._page_rows())
        frac = max(min(self.cfg.kv_arena_frac, 1.0), 0.0)
        want = int(round(frac * self.cfg.max_slots * per_slot))
        return max(want, per_slot, 1)

    def _make_arena(self):
        if not self.cfg.paged_kv:
            frac = max(min(self.cfg.kv_arena_frac, 1.0), 0.0)
            per_slot = self._row_cap() * self._per_token_elems
            return FlexArena(max(int(round(frac * self._arena_capacity())),
                                 per_slot, 1))
        return PagedArena(self._arena_pages(), self._page_rows(),
                          self._per_token_elems)

    @property
    def _paged(self) -> bool:
        return isinstance(self.arena, PagedArena)

    def _live_rows(self, req: Request) -> int:
        """Rows a paged request's table must cover for the next dispatch."""
        return min(self._dec_len(req) + 1, self._row_cap())

    def _arena_rows(self, req: Request) -> int:
        return self._live_rows(req) if self._paged else self._slot_rows(req)

    def _oversized(self, req: Request) -> bool:
        return self._slot_rows(req) > self.cfg.max_len

    # ------------------------------------------------------------------
    # preemption: park a victim's device state host-side, release its
    # slot and pages, resume later with an exact continuation
    # ------------------------------------------------------------------
    def _export_slot(self, slot: int) -> PyTree:
        """One slot's cache rows as a host-side copy (slot dim kept; a
        copy even when the cache lies on the CPU, where ``.cpu()`` would
        alias the pool)."""
        return _tree_map(
            lambda ax, t: torch.zeros(()) if ax < 0
            else t.narrow(ax, slot, 1).to("cpu", copy=True),
            self._slot_axes, self.cache)

    def _release_slot(self, slot: int, req: Request) -> None:
        """Single exit point returning a request's slot and its arena
        reservation together."""
        if req.view is not None:
            self.arena.free_view(req.view)
            req.view = None
        self._active.pop(slot, None)
        self._inject.pop(slot, None)
        self._free_slots.append(slot)
        req.slot = -1

    def preempt_slot(self, slot: int) -> Optional[int]:
        """Save the slot's cache rows host-side, free its pages and slot,
        and park the request for re-admission."""
        self._harvest()
        req = self._active.get(slot)
        if req is None:
            return None
        block = self._export_slot(slot)
        self._release_slot(slot, req)
        self._parked.append((req, block))
        self.preempt_count += 1
        self._obs.inc("preemptions")
        return req.rid

    def _victim_slot(self) -> Optional[int]:
        """The active request with the most remaining budget (newest rid
        breaks ties); None when nothing is preemptible."""
        best = None
        for slot, req in self._active.items():
            rem = req.max_new_tokens - req.scheduled
            if rem <= 0:
                continue
            key = (rem, req.rid, slot)
            if best is None or key > best[0]:
                best = (key, slot)
        return best[1] if best is not None else None

    def preempt_one(self) -> Optional[int]:
        self._harvest()
        slot = self._victim_slot()
        if slot is None:
            return None
        return self.preempt_slot(slot)

    def _ensure_capacity(self) -> None:
        """Grow each live slot's page table to cover the next dispatch;
        page exhaustion preempts the largest-remaining victim."""
        if not self._paged:
            return
        for slot in sorted(self._active):
            req = self._active.get(slot)
            if req is None or req.view is None:
                continue
            need = self._live_rows(req)
            while True:
                try:
                    self.arena.grow(req.view, need)
                    break
                except AllocationError:
                    victim = self._victim_slot()
                    if victim is None:
                        break
                    self.preempt_slot(victim)
                    if victim == slot:
                        break

    def _resume_parked(self) -> None:
        """Re-admit preempted requests (exact state restore) while a slot
        and their pages are available."""
        harvested = False
        while self._parked and self._free_slots:
            req, block = self._parked[0]
            try:
                view = self.arena.alloc(self._arena_rows(req),
                                        self._per_token_elems, ROLE_ACT)
            except AllocationError:
                break
            if not harvested:
                self._harvest()
                harvested = True
            self._parked.pop(0)
            req.view = view
            req.slot = self._free_slots.pop(0)
            _write_slot(self.cache, block, req.slot, self._slot_axes)
            self._active[req.slot] = req
            if req.out_tokens:
                self._inject[req.slot] = req.out_tokens[-1]
            self._obs.inc("preempt_resumes")

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------
    def _dec_len(self, req: Request) -> int:
        """KV occupancy the next dispatch reads: ``pos + 1``."""
        return len(req.tokens) + req.scheduled

    def _kv_bound(self) -> int:
        longest = max((self._dec_len(r) for r in self._active.values()),
                      default=1)
        return min(_round_block(longest), self.cfg.max_len)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _decode_fn(self, prev, inject_vals, inject_mask, live):
        # next input token per slot: host-injected (fresh prefill / sync
        # mode) or the previous step's device-resident output (pipelined)
        toks = torch.where(inject_mask, inject_vals, prev)[:, None]
        kv_bound = (self._kv_bound() if self.cfg.use_kernels
                    and not self.model.cfg.attention_free else None)
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, toks, use_kernels=self.cfg.use_kernels,
            kv_bound=kv_bound, live_mask=live)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.where(live, nxt, torch.zeros_like(nxt))

    def _prefill_fn(self, tokens, true_len: int, slot: int):
        """Prefill one prompt straight into its pool slot, whose rows past
        the prompt are zeroed first (the reference writes a fresh
        single-slot cache); returns the first token on the device."""
        view = _slot_view(self.cache, self._slot_axes, slot)
        _tree_map(lambda ax, t: t.zero_() if ax >= 0 else None,
                  self._slot_axes, view)
        logits, filled = self.model.prefill(
            self.params, {"tokens": tokens}, view, true_len=true_len,
            use_kernels=self.cfg.use_kernels)
        _write_slot(self.cache, filled, slot, self._slot_axes)
        return torch.argmax(logits[0]).to(torch.int32)

    # ------------------------------------------------------------------
    # load signals
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def preempted_depth(self) -> int:
        return len(self._parked)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active or self._inflight
                    or self._parked)

    def pending_tokens(self) -> int:
        """Decode steps still owed by active, parked and queued requests."""
        owed = sum(req.max_new_tokens - req.scheduled
                   for req in self._active.values())
        owed += sum(req.max_new_tokens - req.scheduled
                    for req, _ in self._parked)
        owed += sum(req.max_new_tokens + len(req.tokens)
                    for req in self._queue)
        return max(owed, 0)

    def arena_utilization(self) -> float:
        return self.arena.utilization()

    def recent_lengths(self) -> Tuple[int, ...]:
        return self._recent_lens.lengths()

    def stats(self) -> Dict[str, Any]:
        return {
            "workload_class": self.workload_class,
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "pending_tokens": self.pending_tokens(),
            "arena_utilization": round(self.arena_utilization(), 4),
            "preempted": self.preempted_depth,
            "preemptions": self.preempt_count,
        }

    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16) -> int:
        """Queue one request; returns its rid.  Requests that could never
        fit a slot are rejected but recorded."""
        rid = self._next_rid
        self._next_rid += 1
        toks = np.asarray(tokens, np.int32)
        self._recent_lens.append(len(toks))
        self._queue.append(Request(rid, toks, max_new_tokens,
                                   submitted_s=time.perf_counter()))
        self._obs.inc("requests_submitted")
        return rid

    def _admit(self) -> None:
        """Move queued requests into free slots while the arena admits
        them, prefill them, then resume parked requests."""
        admitted: List[Request] = []
        while self._queue and self._free_slots:
            req = self._queue[0]
            if self._oversized(req):
                req.done = True
                self._queue.pop(0)
                self._record_finished(req)
                continue
            try:
                view = self.arena.alloc(self._arena_rows(req),
                                        self._per_token_elems, ROLE_ACT)
            except AllocationError:
                break   # arena full: stay queued
            self._queue.pop(0)
            req.view = view
            req.slot = self._free_slots.pop(0)
            self._active[req.slot] = req
            admitted.append(req)
        if admitted:
            obs = self._obs
            if obs.enabled:
                now = time.perf_counter()
                for req in admitted:
                    if req.submitted_s > 0.0:
                        obs.observe("queue_wait_s", now - req.submitted_s)
            with obs.span("admit", n=len(admitted)):
                for req in admitted:
                    self._prefill_into_slot(req)
        self._resume_parked()

    def _bucketed(self, length: int) -> int:
        bucket = max(self.cfg.prefill_bucket, 8)
        return -(-length // bucket) * bucket

    def _prefill_into_slot(self, req: Request) -> None:
        """Prefill one request into its slot.  Attention archs pad the
        prompt to its bucket and pass ``true_len``: KV past the true length
        is masked by the slot's position and overwritten by later decodes.
        SSM archs carry recurrent state that padding would corrupt, so they
        prefill at the exact prompt length."""
        L = len(req.tokens)
        nb = self._bucketed(L) if self.model.cfg.ssm is None else L
        toks = np.zeros((1, nb), np.int32)
        toks[0, :L] = req.tokens
        with self._obs.timed("prefill", "prefill_s", len=L):
            first_dev = self._prefill_fn(self._to_device(toks), L, req.slot)
            first = int(first_dev.cpu())        # sync point: the first token
        req.out_tokens.append(first)
        req.scheduled = 1
        self._inject[req.slot] = first
        if req.submitted_s > 0.0 and self._obs.enabled:
            self._obs.observe("ttft_s", time.perf_counter() - req.submitted_s)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admit -> dispatch decode -> harvest.
        Returns [(rid, token)] newly observed on the host; under pipelined
        decode these are the previous dispatch's tokens."""
        self._admit()
        if not self._active:
            self._harvest()
            return self._drain_emitted()
        with self._obs.timed("decode_step", "decode_step_s"):
            self._step_dispatch()
        out = self._drain_emitted()
        obs = self._obs
        if obs.enabled:
            obs.set_gauge("slot_utilization",
                          len(self._active) / max(self.cfg.max_slots, 1))
            obs.set_gauge("arena_utilization", self.arena.utilization())
        return out

    def _step_dispatch(self) -> None:
        self._ensure_capacity()
        if not self._active:
            return
        B = self.cfg.max_slots
        pipelined = self.cfg.pipeline_decode and self.cfg.eos_id < 0
        host = np.zeros((3, B), np.int32)   # inject values, inject mask, live
        for slot, req in self._active.items():
            host[2, slot] = 1
            if not pipelined:
                host[1, slot] = 1
                host[0, slot] = req.out_tokens[-1]
            elif slot in self._inject:
                host[1, slot] = 1
                host[0, slot] = self._inject[slot]
        dev = self._to_device(host)
        prev = (self._inflight.nxt if self._inflight is not None
                else torch.zeros(B, dtype=torch.int32, device=self.device))
        nxt = self._decode_fn(prev, dev[0], dev[1].bool(), dev[2].bool())
        ready = None
        if self.device.type == "cuda":
            host_nxt = torch.empty(B, dtype=torch.int32, pin_memory=True)
            host_nxt.copy_(nxt, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host_nxt = nxt
        self._inject.clear()

        entries = []
        for slot in list(self._active):
            req = self._active[slot]
            req.scheduled += 1
            finishing = req.scheduled >= req.max_new_tokens
            entries.append((slot, req, finishing))
            if pipelined and finishing:
                # length-based completion is known at dispatch time: free
                # the slot now; the token value lands at harvest
                req.done = True
                self._release_slot(slot, req)

        # harvest the PREVIOUS dispatch while this one runs; its continuing
        # slots are fed by the dispatch just made, so no re-injection
        self._harvest(register_inject=False)
        self._inflight = _Inflight(nxt, host_nxt, ready, entries, pipelined)
        if not pipelined or not self._active:
            self._harvest()

    def _harvest(self, register_inject: bool = True) -> None:
        """Read one in-flight dispatch's tokens back to the host."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        if inf.ready is not None:
            inf.ready.synchronize()             # sync point: the step's tokens
        nxt = inf.host.numpy()
        for slot, req, finishing in inf.entries:
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self._emit_buf.append((req.rid, tok))
            if inf.pipelined:
                if finishing:
                    self._record_finished(req)
                elif register_inject:
                    self._inject[slot] = tok
            elif tok == self.cfg.eos_id or \
                    len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self._release_slot(slot, req)
                self._record_finished(req)

    def _drain_emitted(self) -> List[Tuple[int, int]]:
        out, self._emit_buf = self._emit_buf, []
        if out:
            self._obs.inc("tokens_emitted", len(out))
        return out

    def _record_finished(self, req: Request) -> None:
        self._finished[req.rid] = list(req.out_tokens)
        self._evict_finished()

    def run_to_completion(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Step until idle (or ``max_steps``); returns ``snapshot()``."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        return self.snapshot()

    def results(self) -> Dict[int, List[int]]:
        """Completed (or rejected) requests' emitted tokens."""
        self._harvest()
        return {rid: list(toks) for rid, toks in self._finished.items()}

    def snapshot(self) -> Dict[int, List[int]]:
        """Every request seen so far -> tokens emitted."""
        self._harvest()
        out = {req.rid: list(req.out_tokens)
               for req in list(self._active.values()) + self._queue}
        out.update({req.rid: list(req.out_tokens)
                    for req, _ in self._parked})
        out.update({rid: list(toks) for rid, toks in self._finished.items()})
        return out
