"""Serving-side two-stage DSE of the port (``repro.serve.dse``) — Stage 1:
the per-tenant design-point optimizer (paper §3.1's "analytical model with
a two-stage DSE", run *live* in the serving loop).

The offline DSE (:mod:`repro_torch.core.dse`) optimizes per-layer
runtime parameters (Stage 1) and then schedules over the resulting mode
tables (Stage 2).  The serving fabric runs the same split at tenant
granularity:

* **Stage 1 (here)** — for each candidate CU grant ``c``, pick the tenant's
  best *engine configuration* with the analytical model: data-parallel
  replica count (the grant tiled into ``dp`` independent slices),
  tensor-parallel degree over one slice, per-replica decode/SSM slot count
  (batch per step, memory-feasibility bounded, priced via ``batch`` in the
  step cost), and the encoder/enc-dec bucket ladder (fit to observed job
  lengths).  The result is a per-(tenant, c)
  :class:`~repro_torch.core.dse.DesignPoint` memo;
* **Stage 2** — :class:`~repro_torch.serve.fabric.AnalyticalPolicy`'s split
  search minimizes predicted makespan over compositions of those
  Stage-1-optimal points, and
  :class:`~repro_torch.serve.fabric.ComposedServer` applies the winning
  points live (``Engine.apply``).

The arithmetic is the reference's.  On one GPU the fabric runs it with
``tp_allowed=False`` (one device has no tensor parallelism), prices a CU
as a share of the card (``common.platform.per_cu``) and sets
``mem_budget_bytes`` to one CU's share of the HBM that every tenant's
weights leave free.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Tuple

from repro_torch.common.platform import (DEFAULT_CUS, H100_SXM,
                                         PlatformProfile, per_cu)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.analytical import (dp_dispatch_overhead,
                                         tp_collective_latency)
from repro_torch.core.dse import DesignPoint, dp_candidates, tp_candidates
from repro_torch.workloads.base import (DECODE, ENCDEC, ENCODER,
                                        length_buckets, pick_bucket)

__all__ = ["DesignPoint", "Stage1Optimizer", "TenantDesignSpace",
           "design_key", "padded_factor"]


def design_key(cus: int, design: Mapping[str, object]) -> str:
    """Compact stable identity of an *applied* design point, e.g.
    ``"c4-tp2-dp1-s8"`` (plus ``-b128.512`` when a bucket ladder is set).

    Built from a group's grant width and ``Engine.design()`` output, so two
    tenants (or the same tenant before/after a retune) land on the same key
    iff they run the same configuration.  The fabric's
    :class:`repro_torch.obs.PredictionLedger` files predicted and measured step
    costs under this key — the per-(class, design point) axis of the
    ``predicted_vs_measured`` summary."""
    tp = design.get("tp")
    dp = design.get("dp") or 1
    buckets = design.get("buckets")
    key = (f"c{int(cus)}-tp{int(tp) if tp else 0}-dp{int(dp)}"
           f"-s{int(design.get('slots') or 0)}")
    if buckets:
        key += "-b" + ".".join(str(int(b)) for b in buckets)
    return key


@dataclasses.dataclass(frozen=True)
class TenantDesignSpace:
    """The static bounds of one tenant's Stage-1 search, snapshotted from
    its engine by the fabric each decide tick."""

    wclass: str                          # workload class (repro_torch.workloads)
    max_len: int                         # per-slot decode capacity (tokens)
    max_src: int = 0                     # enc-dec source capacity (frames)
    base_slots: int = 4                  # currently applied slot count
    base_buckets: Tuple[int, ...] = ()   # currently applied bucket ladder
    base_tp: Optional[int] = None        # applied TP degree (None = grant)
    base_dp: int = 1                     # applied replica count
    per_slot_elems: int = 0              # arena elements one slot pins
    tp_allowed: bool = True              # False on replicated fabrics
    slot_cap: int = 64                   # hard slot-count ceiling
    dp_cap: int = 64                     # hard replica-count ceiling
    # decode-side admission prefill pads prompts up to this bucket (0 =
    # exact-length prefill, e.g. SSM/hybrid archs): Stage 1 prices the
    # padded prefill work instead of treating prompt padding as free
    prefill_bucket: int = 0
    # ragged decode kernels active (ServeConfig.use_kernels): decode
    # steps stream only the live KV/source prefix, so Stage 1 prices the
    # expected observed length instead of the full per-slot capacity
    use_kernels: bool = True
    # paged KV arena (ServeConfig.paged_kv): admission reserves fixed-size
    # (page_rows, cols) pages as a stream grows instead of pinning
    # per_slot_elems up front, so the memory bound on the slot count is the
    # EXPECTED page footprint of a slot — Stage 1 can admit more slots on
    # the same HBM than the worst-case reservation would allow
    paged: bool = False
    page_rows: int = 0
    page_elems: int = 0


def padded_factor(ladder: Sequence[int], lengths: Sequence[int]) -> float:
    """Padded-work multiplier of a bucket ladder over observed job lengths:
    (tokens actually computed at each job's smallest fitting bucket) /
    (valid tokens).  1.0 = no padding waste; the capacity-only ladder on
    short jobs can be 10x+.  Empty observations price at no waste."""
    valid = [L for L in lengths if 0 < L <= ladder[-1]]
    if not valid:
        return 1.0
    return sum(pick_bucket(ladder, L) for L in valid) / sum(valid)


def _quantile(sorted_vals: Sequence[int], frac: float) -> int:
    return sorted_vals[min(int(frac * len(sorted_vals)),
                           len(sorted_vals) - 1)]


class Stage1Optimizer:
    """Per-tenant design-point search on the analytical model.

    ``step_cost`` is the class-aware per-step/per-token price (normally
    ``AnalyticalPolicy.step_cost`` — passing the bound method keeps the
    policy's memo as the shared price table).  Stage 1 layers on top of it
    the terms the split search alone cannot see:

    * the **tensor-parallel trade**: sharding a step over ``p`` CUs divides
      its bandwidth terms by ``p`` but adds ``2(p-1)`` all-reduce phases
      per layer (:func:`tp_collective_latency`) — small models stop
      scaling early, and the optimal ``tp`` can be < the grant;
    * the **batching trade**: ``slots`` decode streams amortize one step's
      weight traffic over ``slots`` tokens, but only ``min(slots, queue)``
      streams exist to fill them, and every slot pins arena memory;
    * the **padding trade**: a bucket ladder fit to observed job lengths
      cuts the encode phase's padded FLOPs (:func:`padded_factor`).
    """

    def __init__(self, step_cost: Callable,
                 platform: Optional[PlatformProfile] = None, *,
                 slot_choices: Tuple[int, ...] = (1, 2, 4, 8, 16),
                 mem_budget_bytes: Optional[float] = None):
        self.step_cost = step_cost
        # one CU's profile (default: an eighth of one H100)
        platform = (platform if platform is not None
                    else per_cu(H100_SXM, DEFAULT_CUS))
        self.platform = platform
        self.slot_choices = tuple(sorted(set(slot_choices)))
        # HBM a tenant's slot pool may pin per granted CU (params, single
        # caches and headroom take the rest)
        self.mem_budget_bytes = (mem_budget_bytes if mem_budget_bytes
                                 is not None else platform.hbm_bytes / 2)

    # -- cost terms --------------------------------------------------------
    def collective_s(self, cfg: ModelConfig, batch: int, p: int,
                     space: Optional[TenantDesignSpace] = None) -> float:
        """Per-step tensor-parallel synchronization cost: ~2 all-reduces of
        the (batch, d_model) activations per layer at degree ``p``.  A
        replicated fabric (``tp_allowed=False``) runs no collectives at
        all, so its engines pay nothing regardless of grant.  Encoder-class
        work shards the encoder stack, so it pays over the same layer count
        ``step_cost`` prices its compute on."""
        if space is not None and not space.tp_allowed:
            return 0.0
        layers = (cfg.encoder_layers or cfg.num_layers
                  if space is not None and space.wclass == ENCODER
                  else cfg.num_layers)
        bytes_per = 4.0 * max(batch, 1) * cfg.d_model
        return layers * 2.0 * tp_collective_latency(
            self.platform, p, bytes_per)

    def _expected_src(self, space: TenantDesignSpace,
                      ladder: Tuple[int, ...],
                      lengths: Sequence[int], src_cap: int) -> int:
        """Expected per-slot source length an enc-dec tenant's
        cross-attention reads under ``ladder`` (falls back to the capacity
        when no lengths were observed — the pre-DSE pricing).  With the
        ragged kernels active the cross read is the *true* source length,
        not the padded bucket."""
        valid = [L for L in lengths if 0 < L <= ladder[-1]]
        if not valid:
            return src_cap or space.max_src or space.max_len
        if space.use_kernels:
            return max(1, sum(valid) // len(valid))
        return max(1, sum(pick_bucket(ladder, L) for L in valid)
                   // len(valid))

    def _expected_kv(self, space: TenantDesignSpace,
                     lengths: Sequence[int]) -> int:
        """Decoder-KV length a decode step streams per slot: the full
        per-slot capacity on the padded path (masked rows still read), the
        mean observed prompt length under the ragged kernels (no
        observations -> capacity, so an idle tenant is never under-priced)."""
        if not space.use_kernels:
            return space.max_len
        valid = [L for L in lengths if 0 < L <= space.max_len]
        if not valid:
            return space.max_len
        return max(1, min(sum(valid) // len(valid), space.max_len))

    def _prefill_tax(self, cfg: ModelConfig, space: TenantDesignSpace,
                     p: int, lengths: Sequence[int]) -> float:
        """Amortized per-step price of decode-side admission prefill: each
        admitted prompt runs one padded full-sequence pass (length rounded
        up to ``prefill_bucket``), paid once per request and spread over the
        request's expected decode steps, so Stage 1 sees a bucket
        mismatched to the traffic."""
        if space.prefill_bucket <= 0:
            return 0.0
        valid = [L for L in lengths if 0 < L <= space.max_len]
        if not valid:
            return 0.0
        bucket = max(space.prefill_bucket, 8)
        padded = [min(-(-L // bucket) * bucket, space.max_len)
                  for L in valid]
        mean_len = sum(valid) / len(valid)
        mean_pad = sum(padded) / len(padded)
        per_tok = self.step_cost(cfg, 1, p, ENCODER)
        steps = max(space.max_len - mean_len, 1.0)
        return per_tok * mean_pad / steps

    def cost_of(self, cfg: ModelConfig, space: TenantDesignSpace,
                concurrency: int, point: DesignPoint,
                lengths: Sequence[int] = (), src_cap: int = 0) -> float:
        """Predicted seconds per unit of owed work at a pinned design point
        (the hysteresis baseline: what the *currently applied* point costs
        under the current load).

        ``point.dp`` replicas tile the grant into ``cus // dp``-CU slices,
        each running an independent engine at ``slots`` slots: throughput
        multiplies by the replicas the queue can fill (``min(dp*slots,
        k)``), the TP degree is clamped to one slice's width, and every
        replica past the first pays the host dispatch serialization tax
        (:func:`~repro_torch.core.analytical.dp_dispatch_overhead`)."""
        c = point.cus
        if c <= 0:
            return float("inf")
        d = max(1, min(point.dp or space.base_dp, c))
        w = max(c // d, 1)                     # CUs per replica slice
        p = min(point.tp or w, w)
        slots = point.slots or space.base_slots
        ladder = length_buckets(point.buckets if point.buckets is not None
                                else space.base_buckets,
                                space.max_src or space.max_len)
        k = max(concurrency, 1)
        if space.wclass == ENCODER:
            per_tok = self.step_cost(cfg, slots, p, ENCODER)
            coll = self.collective_s(cfg, 1, p, space)
            return (per_tok * padded_factor(ladder, lengths) + coll) / d
        if space.wclass == ENCDEC:
            src = self._expected_src(space, ladder, lengths, src_cap)
            base = self.step_cost(cfg, slots, p, ENCDEC, src_len=src,
                                  kv_len=space.max_len)
        elif space.wclass == DECODE:
            base = self.step_cost(cfg, slots, p, DECODE,
                                  kv_len=self._expected_kv(space, lengths))
        else:
            base = self.step_cost(cfg, slots, p, space.wclass)
        per_step = (base + self.collective_s(cfg, slots, p, space)
                    + dp_dispatch_overhead(d)) / min(d * slots, k)
        # decode-side prompt padding at admission is work too (the prefill
        # bucket is not free)
        if space.wclass == DECODE:
            per_step += self._prefill_tax(cfg, space, p, lengths)
        return per_step

    def _per_slot_bytes(self, space: TenantDesignSpace,
                        lengths: Sequence[int]) -> float:
        """Expected HBM one slot pins: the full worst-case reservation on a
        slot-granular arena; on a paged arena the whole-page footprint of a
        slot's *lifetime-average* live rows — the midpoint between the
        expected admission length and the per-slot capacity (no
        observations -> capacity, so an idle tenant is never
        under-priced)."""
        worst = 4.0 * space.per_slot_elems
        if (not space.paged or space.page_rows <= 0
                or space.page_elems <= 0):
            return worst
        valid = [L for L in lengths if 0 < L <= space.max_len]
        rows = (min((sum(valid) / len(valid) + space.max_len) / 2.0,
                    space.max_len)
                if valid else space.max_len)
        pages = -(-int(max(rows, 1)) // space.page_rows)
        expected = 4.0 * pages * space.page_elems
        return min(expected, worst) if worst > 0 else expected

    # -- the search --------------------------------------------------------
    def _slot_candidates(self, space: TenantDesignSpace, concurrency: int,
                         p: int, lengths: Sequence[int] = ()
                         ) -> Tuple[int, ...]:
        """Arena-feasible slot counts worth trying at TP degree ``p``: the
        preset ladder plus the applied count and the observed concurrency
        (rounded up to even), memory-bounded by the slot pool the ``p``
        compute CUs' HBM can pin (expected page footprint per slot on a
        paged arena, worst-case reservation otherwise)."""
        cap = space.slot_cap
        per_bytes = self._per_slot_bytes(space, lengths)
        if per_bytes > 0:
            by_mem = int(p * self.mem_budget_bytes // per_bytes)
            cap = max(1, min(cap, by_mem))
        want = min(max(concurrency, 1), cap)
        cands = {s for s in self.slot_choices if s <= cap}
        cands.add(min(space.base_slots, cap))
        cands.add(min(want + (want % 2), cap))     # cover the queue
        return tuple(sorted(c for c in cands if c >= 1))

    def _ladder_candidates(self, space: TenantDesignSpace,
                           lengths: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
        """Candidate bucket ladders: the applied one, capacity-only, and
        quantile ladders fit to the observed length distribution (p50 and
        p50+p90 breakpoints, rounded up to 8)."""
        cap = space.max_src or space.max_len
        cands = {length_buckets(space.base_buckets, cap),
                 length_buckets((), cap)}
        valid = sorted(L for L in lengths if 0 < L <= cap)
        if valid:
            r8 = lambda v: min(-(-v // 8) * 8, cap)          # noqa: E731
            p50, p90 = _quantile(valid, 0.5), _quantile(valid, 0.9)
            cands.add(length_buckets((r8(p50),), cap))
            cands.add(length_buckets((r8(p50), r8(p90)), cap))
        return tuple(sorted(cands))

    def best(self, cfg: ModelConfig, space: TenantDesignSpace,
             concurrency: int, cus: int, lengths: Sequence[int] = (),
             src_cap: int = 0) -> DesignPoint:
        """Stage 1 proper: the tenant's cheapest design point on a
        ``cus``-CU grant, searched jointly over ``(dp, tp, slots,
        buckets)``.  Ties break toward the currently applied knobs
        (stability: a reconfiguration must buy something)."""
        if cus <= 0:
            return DesignPoint(cus=0, cost=float("inf"))
        has_encode = space.wclass in (ENCODER, ENCDEC)
        ladders = (self._ladder_candidates(space, lengths) if has_encode
                   else (None,))
        base_ladder = length_buckets(space.base_buckets,
                                     space.max_src or space.max_len)
        dps = tuple(d for d in dp_candidates(cus, 1)
                    if d <= max(space.dp_cap, 1)) or (1,)
        applied_dp = max(1, min(space.base_dp, cus))
        k = max(concurrency, 1)
        best = None
        for dp in dps:
            w = max(cus // dp, 1)              # CUs per replica slice
            tps = tp_candidates(w) if space.tp_allowed else (w,)
            # what the engine would run at on THIS slice if nothing changed
            applied_tp = min(space.base_tp or w, w)
            per_k = -(-k // dp)                # per-replica queue share
            for tp in tps:
                slot_cands = ((space.base_slots,)
                              if space.wclass == ENCODER
                              else self._slot_candidates(space, per_k, tp,
                                                         lengths))
                for slots in slot_cands:
                    for ladder in ladders:
                        point = DesignPoint(cus=cus, tp=tp, slots=slots,
                                            buckets=ladder, dp=dp)
                        cost = self.cost_of(cfg, space, concurrency, point,
                                            lengths, src_cap)
                        # deviation from the applied knobs: tie-break only
                        # (reconfiguring must buy something, so ties never
                        # trigger a gratuitous reshard/resize/ladder swap)
                        dev = ((0 if dp == applied_dp else 1)
                               + (0 if tp == applied_tp else 1)
                               + (0 if slots == space.base_slots else 1)
                               + (0 if ladder in (None, base_ladder) else 1))
                        cand = (cost, dev,
                                dataclasses.replace(point, cost=cost))
                        if best is None or cand[:2] < best[:2]:
                            best = cand
        assert best is not None
        return best[2]
