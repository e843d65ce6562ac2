"""Real-time recomposition controller of the port (``repro.serve.fabric``
on one GPU) — the serving-side face of FILCO's "reconfigured in real-time
and flexibly composed into a unified or multiple independent accelerators"
(paper §1, §2.1).

A :class:`ComposedServer` owns one card, composed of ``num_cus`` logical
CUs by a :class:`~repro_torch.core.composer.CUComposer`.  Each tenant runs
the engine of its *workload class* (transformer decode or SSM recurrent
decode, :mod:`repro_torch.workloads`) as a :class:`ReplicaGroup` — ``dp``
co-resident engine replicas of one design, which share the tenant's
parameter tensors.  Between decode steps the controller samples per-tenant
load (queue depth, owed work, arena pressure) and asks a policy — by
default the analytical model driving the serving DSE, pricing each tenant
by its class's bound resource — for a new composition of design points.
When the predicted gain clears the hysteresis threshold it recomposes live.

What a CU grant is on one card (the reference's CU is a mesh column with
its own HBM; this port's is a share of the one card):

* the policy prices a tenant on ``c`` of ``N`` CUs as ``c/N`` of the card's
  compute, bandwidth and HBM (``common.platform.per_cu``; ``N`` is the
  server's ``num_cus``, 8 by default as the reference's 8-column fabric);
* the grant sets the tenant's slot and arena budgets: Stage 1 bounds a
  tenant's slots by its share of the HBM that every tenant's weights leave
  free (weights stay resident whatever the grant, a parked tenant's too);
* each engine serves on its own CUDA stream, so the tenants' steps overlap
  on the card (the one-GPU counterpart of disjoint sub-meshes).  SMs are
  not partitioned: whether a share leaks shows in the prediction ledger
  (predicted against measured per-token cost per design key);
* a "move" migrates no weights: ``apply`` with a new grant records the
  share, and the slot retune is the real action.  A parked tenant (0 CUs)
  keeps its pool and is not stepped.

On a mesh (``ComposedServer(tenants, mesh=..., tp=True)``: a torch
``DeviceMesh`` over one rank per GPU, or gloo CPU ranks) a CU is what the
reference makes it, one column of the mesh's model dim: a
:class:`~repro_torch.core.composer.MeshComposer` carves the columns into
disjoint sub-meshes, each tenant's engine (of every workload class)
shards its params and pooled KV or state over its own
(``serve_engine_rules``; ``tp=False`` keeps them whole on each of its
ranks), and a recomposition moves only the tenants whose ranks change,
params and live KV, while the others keep their ranks and tensors.
Every rank runs the fabric, in the same order; the policy, SLO
preemption, termination by EOS, replica groups and background prewarm
run there as on one card.  A CU is then a whole GPU: the policy prices it
on ``H100_NVLINK`` by default, Stage 1 searches tensor-parallel degrees
(``tp_allowed`` under TP rules) priced on its NVLink term, and bounds a
tenant's slots by what one GPU's HBM holds past the tenants' weights.  A
``ReplicaGroup`` runs its ``dp`` replicas on disjoint ``replica_submesh``
tiles of the grant, each a TP engine on its tile.  Multi-controller, the
fabric keeps one decision for the whole mesh: what reads a clock of its
own rank (the policy's decision, the SLO pass's victims, whether a
background warm-up is ready to commit) is decided on the mesh's first
rank and broadcast, on decide ticks (on every step while some tenant's
SLO is tracked), and every rank applies it.  The background warm-up runs
its collectives on a process group of its own (``dist.new_group`` over
the world, made by every rank at construction), one job at a time, in
the same order on every rank.  Decisions cross on a gloo group of their
own: host objects, which never wait on the card.  On one card Stage 1
runs with ``tp_allowed=False`` and the fabric issues no collective.

Reconfiguration cost: a new slot count is a new device pool whose decode
steps are captured CUDA graphs (0.13-0.18 s each on the card).  With
``warm`` the target composition's graphs are captured *before* the switch
commits (``warm_compile``), optionally in a background thread
(``prewarm_async``) so capture overlaps serving.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import math
import statistics
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.common.platform import (DEFAULT_CUS, H100_NVLINK,
                                         H100_SXM, PlatformProfile, per_cu)
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.analytical import (AccelConfig, decode_kv_read_latency,
                                         layer_latency, ssm_step_latency)
from repro_torch.core.arena import PagedArena
from repro_torch.core.composer import (CUComposer, MeshComposer,
                                       SubAccelerator, replica_submesh)
from repro_torch.core.dse import DesignPoint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distribution import partitioning as part
from repro_torch.distribution.partitioning import (ShardingRules,
                                                   serve_engine_rules)
from repro_torch.models.model import build_model
from repro_torch.models.ssm import dims as ssm_dims
from repro_torch.obs import MetricsRegistry, PredictionLedger, Telemetry
from repro_torch.serve.dse import (Stage1Optimizer, TenantDesignSpace,
                                   design_key)
from repro_torch.workloads.base import (DECODE, ENCDEC, ENCODER, SSM, Engine,
                                        build_engine, workload_class_of)
from repro_torch.workloads.compile_cache import ExecutableCache
from repro_torch.workloads.decode import ServeConfig, _mesh_of

@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Per-tenant latency targets, milliseconds (0 = that target is
    untracked).  Drives two things in :class:`ComposedServer`:

    * the SLO-aware scheduler: a tenant whose head-of-line queue wait is
      burning its p99 TTFT budget (or whose observed per-token p99 has
      breached target) gets one of its slackest live streams preempted —
      exact device-state save to host — so the freed slot/pages admit the
      waiting request *this* step;
    * :meth:`ComposedServer.slo_attainment`: the fraction of observed
      TTFTs / per-token latencies under each target, read from the same
      ``obs`` histograms the fabric already collects.
    """

    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    per_token_p50_ms: float = 0.0
    per_token_p99_ms: float = 0.0

    def tracked(self) -> bool:
        return any(v > 0 for v in (self.ttft_p50_ms, self.ttft_p99_ms,
                                   self.per_token_p50_ms,
                                   self.per_token_p99_ms))


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant model co-resident on the fabric."""

    name: str
    arch: str                        # architecture registry id
    reduced: bool = True
    serve: ServeConfig = ServeConfig()
    seed: int = 0
    # workload class: "auto" derives from the arch (attention-free SSM ->
    # "ssm", enc-dec with cross-attention -> "encdec", else "decode");
    # "encoder" is a tenant's choice: any arch can serve embeddings
    workload: str = "auto"
    # ceiling on the tenant's data-parallel replica count (Stage-1 dp axis);
    # 1 pins the tenant to a single engine per grant
    dp_cap: int = 64
    # latency targets for the SLO-aware scheduler; None = best-effort
    # tenant (never preempted on latency grounds, absent from attainment)
    slo: Optional[SLOTarget] = None
    # (decoder) layers to build, 0 = the config's own: a depth cut that
    # keeps the published widths, for a fleet that would not fit the card
    layers: int = 0


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """Observed load signals only (kept for telemetry; the policy's input
    is :class:`TenantObservation`)."""

    pending_tokens: int              # decode steps of work owed
    queue_depth: int                 # requests awaiting admission
    active: int                      # live decode slots
    arena_utilization: float         # KV arena pressure, 0..1


@dataclasses.dataclass(frozen=True)
class TenantObservation:
    """Everything the policy needs to know about one tenant, in one record.

    Built by the fabric each decide tick (:meth:`ComposedServer.observe`)
    and passed as ``decide(observations={tenant: TenantObservation(...)})``.
    """

    # load signals (sampled from the tenant's engine / replica group)
    pending_tokens: int = 0          # owed work units (steps / prompt toks)
    queue_depth: int = 0             # requests awaiting admission
    active: int = 0                  # live decode slots (all replicas)
    arena_utilization: float = 0.0   # KV-arena pressure, 0..1
    # workload identity + observed traffic (Stage-1 inputs)
    wclass: Optional[str] = None     # workload class (None: derive from cfg)
    recent_lengths: Tuple[int, ...] = ()   # recently observed job lengths
    src_len: int = 0                 # enc-dec per-slot source capacity
    space: Optional[TenantDesignSpace] = None   # Stage-1 search bounds


@dataclasses.dataclass(frozen=True)
class RecompositionEvent:
    """One applied recomposition, for logs/benchmarks."""

    step: int
    sizes_before: Dict[str, int]
    sizes_after: Dict[str, int]
    moved: Tuple[str, ...]
    unchanged: Tuple[str, ...]
    parked: Tuple[str, ...]
    seconds: float                   # the apply phase (retunes, shares)
    reason: str
    # tenants whose CU set did not move but whose engine design point
    # (slots / replicas) was reconfigured live, and the per-tenant knobs
    # actually applied (DSE Stage-1 deltas)
    retuned: Tuple[str, ...] = ()
    design: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # touched tenant -> wall time of its first step on the new composition
    # (where an unwarmed graph capture would land) — filled in by
    # ComposedServer.step()
    post_step_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # graph captures performed before the switch committed
    warm_compile_seconds: float = 0.0
    warm_builds: int = 0             # cold builds performed while warming
    overlapped: bool = False         # warmed in the background thread


# ---------------------------------------------------------------------------
# policy: Stage-2-style split search on the analytical model
# ---------------------------------------------------------------------------

# tile of sequence tokens used to price encoder (full-sequence MM) work in
# its compute-bound regime; the per-token cost is normalized back out
ENC_COST_TILE = 128


def _composed_total_s(lb, cus: int) -> float:
    """Latency of an MM layer on a composed sub-accelerator.

    ``layer_latency`` models the board, where every CU shares one DDR — its
    DDR/stream terms are flat in CU count.  On the fabric a CU carries its
    share of the bandwidth (a mesh column's own HBM in the reference, a
    share of the card's here), so bandwidth scales with the grant; all
    workload classes are priced on that same assumption
    (``ssm_step_latency`` already divides by CUs).  Compute is already
    divided by CUs inside ``layer_latency``."""
    c = max(cus, 1)
    return max(lb.compute_s, lb.ddr_s / c, lb.stream_s / c) + lb.launch_s


class AnalyticalPolicy:
    """The serving-side DSE Stage 2: chooses a *composition of design
    points* by pricing each tenant on candidate sub-accelerator grants with
    the analytical latency model and minimizing the predicted makespan of
    the owed work.

    ``platform`` is ONE CU's profile: by default an eighth of one H100
    (``per_cu(H100_SXM, 8)``); a fabric of ``N`` CUs takes
    ``per_cu(H100_SXM, N)``, and a fabric on a mesh, whose CU is a GPU,
    ``H100_NVLINK`` (its default there: ``ComposedServer`` builds the
    policy's default for it).

    Two-stage (default): for every candidate CU grant ``c`` the per-tenant
    Stage-1 optimizer (:class:`~repro_torch.serve.dse.Stage1Optimizer`)
    first picks that tenant's best engine configuration — replica count,
    slot count, bucket ladder — and ``decide`` searches splits over those
    Stage-1-optimal :class:`~repro_torch.core.dse.DesignPoint` memos,
    returning per-tenant design points (CUs + knobs) for the fabric to
    apply live.  With ``two_stage=False`` (the split-only ablation, and the
    behavior when the fabric supplies no design spaces) the CU count is the
    whole design point.

    Class-aware costing: each tenant is priced by its workload class's
    bound resource —

    * ``decode``  — bandwidth-bound batched GEMV per decode step (weights
      streamed every token);
    * ``ssm``     — state-bandwidth-bound recurrent update per step
      (``ssm_step_latency``: params + read/write of the O(1) state);
    * ``encoder`` — compute-bound full-sequence MMs per owed prompt token;
    * ``encdec``  — decode-side batched GEMVs plus the per-step
      cross-attention source-cache read, whose bytes scale with the
      tenant's source length (``src_len``).

    Hysteresis: a new split is only worth a live recomposition when the
    predicted speedup clears ``min_gain``.  After every ``decide`` the
    policy exposes ``runner_up``: the best candidate split it did NOT
    return (the hysteresis-rejected best, or the second-best when a switch
    was returned) — the fabric speculatively prewarms it during idle
    decide intervals.
    """

    def __init__(self, platform: Optional[PlatformProfile] = None,
                 min_gain: float = 1.25, two_stage: bool = True):
        # True while the platform is the default one, which a fabric on a
        # mesh replaces with its CU's (``use_platform``)
        self.default_platform = platform is None
        self.min_gain = min_gain
        self.two_stage = two_stage
        self.runner_up: Optional[Dict[str, DesignPoint]] = None
        # last non-idle decision's predicted makespans (telemetry /
        # benchmark): {"best_s": ..., "current_s": ...}
        self.predicted: Optional[Dict[str, float]] = None
        self.use_platform(platform if platform is not None
                          else per_cu(H100_SXM, DEFAULT_CUS))

    def use_platform(self, platform: PlatformProfile) -> None:
        """Price on ``platform`` (one CU's profile) from now on: a fresh
        price table and Stage 1 on it."""
        self.platform = platform
        self._cost_cache: Dict[Tuple, float] = {}
        # Stage 1 shares this policy's step_cost memo as its price table
        self.stage1: Optional[Stage1Optimizer] = (
            Stage1Optimizer(self.step_cost, platform)
            if self.two_stage else None)

    # -- per-tenant per-step cost on a c-CU sub-accelerator ----------------
    def step_cost(self, cfg: ModelConfig, batch: int, cus: int,
                  wclass: str = DECODE, src_len: int = 0,
                  kv_len: int = 0) -> float:
        """Predicted seconds per unit of owed work for one tenant on a
        ``cus``-CU sub-accelerator: per decode step for decode/ssm/encdec
        tenants, per owed prompt token for encoder tenants.

        src_len: enc-dec tenants' per-slot source length (frames read by
        every cross-attention step); ignored for other classes.

        kv_len: decoder-KV length each decode step streams per slot — the
        full per-slot capacity on the padded path, the expected live prefix
        under the ragged decode kernel (Stage 1 passes the estimate; 0
        keeps the term out).  Attention archs only.
        """
        if cus <= 0:
            return float("inf")
        # the key carries the workload class and every priced dim (full and
        # reduced configs share a name)
        kv = kv_len if wclass in (DECODE, ENCDEC) else 0
        key = (wclass, cfg.name, cfg.num_layers, cfg.d_model,
               cfg.d_ff, cfg.num_kv_heads, cfg.resolved_head_dim,
               max(batch, 1), cus, src_len if wclass == ENCDEC else 0, kv)
        if key not in self._cost_cache:
            accel = AccelConfig(
                name=f"sub{cus}", num_cus=cus,
                aies_per_cu=self.platform.num_compute_units,
                onchip_elems=cus * (self.platform.onchip_bytes // 4),
                num_fmus=max(cus, 1), fp=True, fmv=True, fmf=True)
            d = cfg.d_model
            if wclass == SSM and cfg.ssm is not None:
                # recurrent decode: state + parameter bandwidth per step
                d_in, dt_rank, n, w = ssm_dims(cfg)
                cost = cfg.num_layers * ssm_step_latency(
                    accel, self.platform, max(batch, 1), d, d_in, n, w,
                    dt_rank)
            elif wclass == ENCODER:
                # prefill-only: compute-bound full-sequence MMs, priced per
                # owed prompt token
                layers = cfg.encoder_layers or cfg.num_layers
                lb_attn = layer_latency(accel, self.platform,
                                        ENC_COST_TILE, d, d)
                lb_mlp = layer_latency(accel, self.platform,
                                       ENC_COST_TILE, d, cfg.d_ff or 4 * d)
                cost = layers * (2 * _composed_total_s(lb_attn, cus)
                                 + 2 * _composed_total_s(lb_mlp, cus)) \
                    / ENC_COST_TILE
            elif wclass == ENCDEC:
                # enc-dec decode step: the decoder-side batched GEMVs (one
                # extra projection pair for cross-attention) plus the
                # per-step cross-attention source-cache read
                b = max(batch, 1)
                lb_attn = layer_latency(accel, self.platform, b, d, d)
                lb_mlp = layer_latency(accel, self.platform,
                                       b, d, cfg.d_ff or 4 * d)
                cross_read_s = decode_kv_read_latency(
                    accel, self.platform, b, cfg.num_kv_heads,
                    cfg.resolved_head_dim, max(src_len, 1))
                kv_read_s = decode_kv_read_latency(
                    accel, self.platform, b, cfg.num_kv_heads,
                    cfg.resolved_head_dim, kv)
                cost = cfg.num_layers * (
                    3 * _composed_total_s(lb_attn, cus)
                    + 2 * _composed_total_s(lb_mlp, cus)
                    + cross_read_s + kv_read_s)
            else:
                # dominant decode GEMMs per layer: attention out/in (d x d)
                # and the MLP pair (d x d_ff), batched over live slots —
                # plus the per-step decoder-KV stream when priced
                lb_attn = layer_latency(accel, self.platform,
                                        max(batch, 1), d, d)
                lb_mlp = layer_latency(accel, self.platform,
                                       max(batch, 1), d, cfg.d_ff or 4 * d)
                kv_read_s = decode_kv_read_latency(
                    accel, self.platform, max(batch, 1), cfg.num_kv_heads,
                    cfg.resolved_head_dim, kv)
                cost = cfg.num_layers * (
                    2 * _composed_total_s(lb_attn, cus)
                    + 2 * _composed_total_s(lb_mlp, cus)
                    + kv_read_s)
            self._cost_cache[key] = cost
        return self._cost_cache[key]

    # -- the two-stage search ----------------------------------------------
    def decide(self, observations: Mapping[str, TenantObservation],
               cfgs: Mapping[str, ModelConfig],
               current: Mapping[str, object],
               num_cus: int,
               ) -> Tuple[Dict[str, DesignPoint], str]:
        """Return (per-tenant design points, reason).

        Each returned :class:`DesignPoint` carries the tenant's CU grant
        plus its Stage-1-optimal engine knobs (``None`` knobs mean "keep").
        Tenants with no load are parked (cus 0); returning the ``current``
        points means "leave the fabric alone".

        ``observations`` maps tenant -> :class:`TenantObservation`; without
        a design space a tenant is priced split-only (its CU count is the
        whole design point).  ``current`` maps tenant -> applied CU count
        (int) or applied DesignPoint."""
        loads = dict(observations)
        classes = {t: o.wclass for t, o in loads.items()
                   if o.wclass is not None}
        src_lens = {t: o.src_len for t, o in loads.items() if o.src_len}
        lengths = {t: o.recent_lengths for t, o in loads.items()}
        spaces = {t: o.space for t, o in loads.items()
                  if o.space is not None}
        for t in cfgs:
            classes.setdefault(t, workload_class_of(cfgs[t]))
        # arena pressure inflates demand: a hot arena means queued work the
        # pending-token count can't see yet
        demand = {t: ld.pending_tokens * (1.0 + ld.arena_utilization)
                  for t, ld in loads.items()}
        busy = [t for t, d in demand.items() if d > 0]

        def concurrency(t: str) -> int:
            return max(loads[t].active + loads[t].queue_depth, 1)

        def split_only_cost(t: str, c: int) -> float:
            if c <= 0:
                return float("inf")
            cost = self.step_cost(cfgs[t], loads[t].active or 1, c,
                                  classes[t], src_len=src_lens.get(t, 0))
            if self.stage1 is not None and spaces:
                # a space-less tenant in a two-stage decide prices in
                # Stage 1's units (seconds per TOKEN: one batched step
                # emits `active` tokens)
                cost /= max(loads[t].active, 1)
            return cost

        def stage1_point(t: str, c: int) -> DesignPoint:
            """Stage 1: the tenant's best design point on a c-CU grant."""
            sp = spaces.get(t)
            if self.stage1 is not None and sp is not None:
                return self.stage1.best(cfgs[t], sp, concurrency(t), c,
                                        lengths.get(t, ()),
                                        src_lens.get(t, 0))
            return DesignPoint(cus=max(c, 0), cost=split_only_cost(t, c))

        def as_point(t: str, v) -> DesignPoint:
            """Normalize a ``current`` entry and (re-)price it under the
            current load — the hysteresis baseline."""
            if not isinstance(v, DesignPoint):
                return stage1_point(t, int(v))
            sp = spaces.get(t)
            if self.stage1 is not None and sp is not None and v.cus > 0:
                cost = self.stage1.cost_of(cfgs[t], sp, concurrency(t), v,
                                           lengths.get(t, ()),
                                           src_lens.get(t, 0))
            else:
                cost = split_only_cost(t, v.cus)
            return dataclasses.replace(v, cost=cost)

        cur_points = {t: as_point(t, v) for t, v in current.items()}
        if not busy:
            self.runner_up = None
            self.predicted = None
            return dict(cur_points), "idle"

        # Stage-1 memo: one design-point search per (busy tenant, grant)
        memo: Dict[Tuple[str, int], DesignPoint] = {}

        def point(t: str, c: int) -> DesignPoint:
            if (t, c) not in memo:
                memo[(t, c)] = stage1_point(t, c)
            return memo[(t, c)]

        def makespan(points: Mapping[str, DesignPoint]) -> float:
            worst = 0.0
            for t in busy:
                p = points.get(t)
                cost = p.cost if p is not None else float("inf")
                worst = max(worst, demand[t] * cost)
            return worst

        # Stage 2: split search over Stage-1-optimal design points
        best_pts, best_cost = None, float("inf")
        second_pts, second_cost = None, float("inf")
        for split in _candidate_splits(num_cus, busy, demand):
            pts = {t: point(t, c) for t, c in zip(busy, split)}
            cost = makespan(pts)
            if cost < best_cost:
                second_pts, second_cost = best_pts, best_cost
                best_pts, best_cost = pts, cost
            elif cost < second_cost:
                second_pts, second_cost = pts, cost
        assert best_pts is not None

        cur_cost = makespan(cur_points)
        # JSON-safe telemetry: an admit tick's current makespan is infinite
        # (a parked tenant owes work) — record None, not float('inf')
        self.predicted = {
            "best_s": best_cost,
            "current_s": cur_cost if cur_cost != float("inf") else None}
        if cur_cost == float("inf"):
            self.runner_up = second_pts
            return best_pts, "admit"            # a parked tenant got work
        if cur_cost / max(best_cost, 1e-12) >= self.min_gain:
            self.runner_up = second_pts
            if self._sizes(best_pts) == self._sizes(cur_points):
                # same split, better per-tenant configs: a pure Stage-1
                # delta (slots / replicas / ladder) applied with no CU move
                return best_pts, "retune"
            if len(busy) == 1:
                return best_pts, "unify"
            return best_pts, "rebalance"
        # staying put: the best candidate is what we'd switch to next —
        # that's the design worth prewarming while the fabric idles
        self.runner_up = (best_pts
                          if self._sizes(best_pts) != self._sizes(cur_points)
                          else second_pts)
        return dict(cur_points), "hysteresis"

    @staticmethod
    def _sizes(points: Mapping[str, DesignPoint]) -> Dict[str, int]:
        return {t: p.cus for t, p in points.items() if p.cus > 0}


def _compositions(total: int, parts: int):
    """All ways to write ``total`` as ``parts`` positive integers."""
    if parts == 1:
        yield (total,)
        return
    for cuts in itertools.combinations(range(1, total), parts - 1):
        prev, out = 0, []
        for c in cuts:
            out.append(c - prev)
            prev = c
        out.append(total - prev)
        yield tuple(out)


# exhaustive enumeration is C(num_cus-1, tenants-1): fine on a board-scale
# fabric, explosive at scale.  Past this budget, fall back to a
# demand-proportional water-filling split (the argmax of the monotone
# makespan model in the common case, computed in O(cus x tenants)).
MAX_ENUMERATED_SPLITS = 20_000


def _candidate_splits(num_cus: int, busy: Sequence[str],
                      demand: Mapping[str, float]):
    if math.comb(num_cus - 1, len(busy) - 1) <= MAX_ENUMERATED_SPLITS:
        yield from _compositions(num_cus, len(busy))
        return
    total = sum(demand[t] for t in busy)
    shares = [max(1, int(num_cus * demand[t] / total)) for t in busy]
    spare = num_cus - sum(shares)
    order = sorted(range(len(busy)), key=lambda i: -demand[busy[i]])
    i = 0
    while spare != 0:                    # hand leftovers to (or claw back
        j = order[i % len(order)]        # from) the most-loaded tenants
        step = 1 if spare > 0 else (-1 if shares[j] > 1 else 0)
        shares[j] += step
        spare -= step
        i += 1
    yield tuple(shares)


# ---------------------------------------------------------------------------
# data-parallel replica groups: N co-resident engines inside one grant
# ---------------------------------------------------------------------------

class _Replica:
    """One engine instance inside a :class:`ReplicaGroup`, plus its rid
    translation — engine rids are per-engine and restart on adoption, so
    the group owns the stable rid a caller sees (``to_group`` maps the
    engine's rid to it)."""

    __slots__ = ("engine", "to_group", "index", "obs")

    def __init__(self, engine: Engine, index: int = 0, obs=None):
        self.engine = engine
        self.to_group: Dict[int, int] = {}
        self.index = index
        # the Telemetry handle the engine records into: one registry per
        # replica (same labels), so the group can merge histograms across
        # replicas and harvest a retiring replica's registry on a dp shrink
        self.obs = obs


class ReplicaGroup:
    """``dp`` same-design engines tiling one tenant's CU grant (the
    DesignPoint ``dp`` axis).  On one card the replicas are co-resident:
    each has its own slot pool, executable-cache entries and CUDA stream,
    and all share the tenant's parameter tensors (no weight is copied).
    On a mesh each replica is an engine on its own ``replica_submesh``
    tile of the grant (tensor-parallel there under the group's rules);
    every rank keeps every replica's host bookkeeping, a replica's tokens
    come from its tile's first rank, and evacuation and adoption between
    tiles move each live slot's block of shards.

    The group IS the tenant's engine as far as the fabric is concerned —
    same Engine protocol — and owns:

    * **routing**: ``submit`` places each request on the least-loaded
      replica (fewest owed tokens, then shallowest queue, then lowest
      index — deterministic);
    * **merged load signals**: queue depth / active / owed tokens sum
      across replicas, arena pressure averages, ``recent_lengths`` is the
      union — so the policy observes the tenant, not a replica;
    * **the dp retune** (``apply`` with a changed ``point.dp``): retiring
      replicas are drained via ``evacuate`` and their live requests adopted
      by survivors through exact cache-row copies (never re-prefilled — a
      different reduction order could flip an argmax), queues rebalance
      across the new replica set, and every request keeps its stable group
      rid, so per-request streams are bit-identical across the retune;
    * **warm compile across replicas**: each replica's decode steps belong
      to its own pool, so ``warm_compile`` warms every replica of the
      candidate point, and builds (and warms) the replicas a dp growth
      would add; the retune then takes those over.

    Replicas run identical steps on identical weights, so which replica
    serves a request never changes its tokens.
    """

    def __init__(self, wclass: str, model, params, serve_cfg: ServeConfig,
                 *, sub: Optional[SubAccelerator] = None,
                 exec_cache: Optional[ExecutableCache] = None,
                 obs: Optional[Telemetry] = None,
                 rules: Optional[ShardingRules] = None):
        self._wclass = wclass
        self.workload_class = wclass
        self._model = model
        self._params = params            # shared by every replica
        self._serve_cfg = serve_cfg
        self._rules = rules
        self._exec = (exec_cache if exec_cache is not None
                      else ExecutableCache())
        self._granted = sub              # the group's full grant (unsliced)
        self._dp = 1
        self._next_rid = 0
        # group-level telemetry: spans go to the shared tracer; each
        # replica's engine records into a *fresh* registry under the same
        # labels, merged on demand by metrics()
        self._obs = obs if obs is not None else Telemetry()
        # harvested from retired replicas so results()/telemetry survive a
        # dp shrink
        self._retired_results: Dict[int, Any] = {}
        self._retired_builds = 0
        self._retired_reshards = 0
        self._retired_preempts = 0
        self._retired_metrics = MetricsRegistry()
        # growth replicas built and warmed ahead by warm_compile, by index
        self._staged: Dict[int, _Replica] = {}
        rep_obs = self._obs.fresh()
        self._replicas: List[_Replica] = [_Replica(build_engine(
            wclass, model, params, serve_cfg, exec_cache=self._exec,
            obs=rep_obs, mesh=_mesh_of(sub), rules=rules), obs=rep_obs)]

    # -- grant geometry -------------------------------------------------
    @staticmethod
    def _grant_width(granted: Optional[SubAccelerator]) -> Optional[int]:
        return None if granted is None else len(granted.cu_ids)

    def _target_dp(self, granted, point: DesignPoint) -> int:
        dp = point.dp if point.dp is not None else self._dp
        dp = max(int(dp), 1)
        width = self._grant_width(granted)
        return min(dp, width) if width is not None else dp

    def make_meshes(self, sub: Optional[SubAccelerator],
                    point: Optional[DesignPoint] = None) -> None:
        """Create the sub-meshes a candidate design point's replicas run on
        (``sub`` None: the current grant; each tile narrowed to the point's
        TP degree), which every rank of a mesh does in the same order: a
        fabric calls it on its serving thread before a background warm-up
        of the point, which then creates none."""
        point = point if point is not None else DesignPoint(cus=0)
        granted = sub if sub is not None else self._granted
        dp = self._target_dp(granted, point)
        tp = point.tp if point.tp is not None else \
            self._replicas[0].engine.design()["tp"]
        for i in range(dp):
            part.tp_submesh(_mesh_of(replica_submesh(granted, i, dp)), tp)

    @property
    def dp(self) -> int:
        """Live replica count."""
        return self._dp

    @property
    def replicas(self) -> Tuple[Engine, ...]:
        """The member engines, replica index order (tests/telemetry)."""
        return tuple(r.engine for r in self._replicas)

    # -- work ingestion / progress --------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16, **kwargs) -> int:
        """Route one request to the least-loaded replica (owed tokens,
        then queue depth, then replica index — deterministic tie-break);
        returns its stable group rid."""
        rep = min(self._replicas,
                  key=lambda r: (r.engine.pending_tokens(),
                                 r.engine.queue_depth, r.index))
        erid = rep.engine.submit(tokens, max_new_tokens, **kwargs)
        grid = self._next_rid
        self._next_rid += 1
        rep.to_group[erid] = grid
        return grid

    def step(self) -> List[Tuple[int, Any]]:
        """Step every replica; emitted (rid, unit) pairs carry group rids."""
        out: List[Tuple[int, Any]] = []
        for rep in self._replicas:
            out.extend((rep.to_group[erid], v) for erid, v in
                       rep.engine.step())
        return out

    def results(self) -> Dict[int, Any]:
        out = dict(self._retired_results)
        for rep in self._replicas:
            out.update((rep.to_group[erid], v) for erid, v in
                       rep.engine.results().items())
        return out

    def snapshot(self) -> Dict[int, Any]:
        out = dict(self._retired_results)
        for rep in self._replicas:
            out.update((rep.to_group[erid], v) for erid, v in
                       rep.engine.snapshot().items())
        return out

    def run_to_completion(self, max_steps: int = 1000) -> Dict[int, Any]:
        """Step until idle (or ``max_steps``); returns ``snapshot()``."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        return self.snapshot()

    # -- merged load signals --------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(r.engine.queue_depth for r in self._replicas)

    @property
    def active_count(self) -> int:
        return sum(r.engine.active_count for r in self._replicas)

    @property
    def has_work(self) -> bool:
        return any(r.engine.has_work for r in self._replicas)

    def pending_tokens(self) -> int:
        return sum(r.engine.pending_tokens() for r in self._replicas)

    def arena_utilization(self) -> float:
        return (sum(r.engine.arena_utilization() for r in self._replicas)
                / max(len(self._replicas), 1))

    def recent_lengths(self) -> Tuple[int, ...]:
        return tuple(itertools.chain.from_iterable(
            r.engine.recent_lengths() for r in self._replicas))

    # -- preemption (the SLO scheduler's lever) --------------------------
    @property
    def preempted_depth(self) -> int:
        """Requests currently parked (preempted, awaiting re-admission)."""
        return sum(r.engine.preempted_depth for r in self._replicas)

    @property
    def preempt_count(self) -> int:
        return self._retired_preempts + sum(r.engine.preempt_count
                                            for r in self._replicas)

    def queue_head_wait_s(self, now: Optional[float] = None) -> float:
        """Longest head-of-line queue wait across replicas (seconds) —
        the TTFT burn the SLO scheduler compares against targets."""
        waits = [r.engine.queue_head_wait_s(now) for r in self._replicas
                 if r.engine.queue_depth > 0]
        return max(waits) if waits else 0.0

    def preempt_one(self) -> Optional[int]:
        """Preempt one live stream — exact device-state save, re-admitted
        later bit-identically — on the replica whose head-of-line request
        has waited longest (replica-index tie-break).  Returns the victim's
        group rid, or None when no replica holds a preemptible stream.
        The waits are read at one instant, so the order is that of the
        heads' submit stamps, which every rank of a mesh took in the same
        order."""
        now = time.perf_counter()
        order = sorted(
            self._replicas,
            key=lambda r: (-(r.engine.queue_head_wait_s(now)
                             if r.engine.queue_depth > 0 else 0.0),
                           r.index))
        for rep in order:
            erid = rep.engine.preempt_one()
            if erid is not None:
                return rep.to_group.get(erid, erid)
        return None

    # -- pass-throughs the fabric's DSE plumbing reads ------------------
    @property
    def cfg(self) -> ServeConfig:
        return self._replicas[0].engine.cfg

    @property
    def params(self):
        """The tenant's parameters (shared by every replica)."""
        return self._params

    @property
    def arena(self):
        """Replica 0's admission arena (slots are a per-replica knob, so
        per-slot sizing reads one replica)."""
        return getattr(self._replicas[0].engine, "arena", None)

    # -- telemetry -------------------------------------------------------
    @property
    def reshard_count(self) -> int:
        return self._retired_reshards + sum(r.engine.reshard_count
                                            for r in self._replicas)

    @property
    def compile_builds(self) -> int:
        return self._retired_builds + sum(r.engine.compile_builds
                                          for r in self._replicas)

    @property
    def graph_captures(self) -> int:
        """Graph captures of the live replicas (staged ones not counted)."""
        return sum(r.engine.graph_captures for r in self._replicas)

    def take_step_device(self) -> Optional[Tuple[float, int]]:
        """Device seconds and tokens of the replicas' last harvested decode
        steps (summed over replicas; None off the card)."""
        taken = [x for x in (r.engine.take_step_device()
                             for r in self._replicas) if x is not None]
        if not taken:
            return None
        return sum(s for s, _ in taken), sum(n for _, n in taken)

    def metrics(self) -> MetricsRegistry:
        """Merged view of every replica's metrics registry plus the
        registries harvested from replicas retired by dp shrinks — the
        quantiles of the merged histograms describe the *tenant*, not one
        replica."""
        merged = MetricsRegistry()
        merged.merge(self._retired_metrics)
        for rep in self._replicas:
            if rep.obs is not None:
                merged.merge(rep.obs.registry)
        return merged

    def latency_ms(self) -> Dict[str, Dict[str, float]]:
        """Merged-histogram latency summary (milliseconds) for the group's
        key per-step distributions."""
        out: Dict[str, Dict[str, float]] = {}
        reg = self.metrics()
        for name in ("decode_step_s", "ttft_s", "queue_wait_s",
                     "prefill_s", "encode_s"):
            h = reg.merged_histogram(name)
            if h.count:
                out[name[:-2]] = {
                    "p50_ms": round(h.quantile(0.5) * 1e3, 4),
                    "p99_ms": round(h.quantile(0.99) * 1e3, 4),
                    "n": h.count,
                }
        return out

    def stats(self) -> Dict[str, Any]:
        """Group-merged snapshot (sums / averages across replicas), plus
        each replica's own ``stats()`` under ``per_replica``: numerics sum,
        dicts of numerics sum key-wise, anything else is replica 0's."""
        per = [r.engine.stats() for r in self._replicas]
        merged: Dict[str, Any] = {}
        for key in per[0]:
            vals = [s[key] for s in per if key in s]
            head = vals[0]
            if isinstance(head, bool):
                merged[key] = head
            elif isinstance(head, (int, float)):
                merged[key] = type(head)(sum(vals))
            elif isinstance(head, dict) and all(
                    isinstance(v, (int, float)) and not isinstance(v, bool)
                    for d in vals for v in d.values()):
                tot: Dict[Any, Any] = {}
                for d in vals:
                    for k, v in d.items():
                        tot[k] = tot.get(k, 0) + v
                merged[key] = tot
            else:
                merged[key] = head       # replicas share one design
        merged.update({
            "workload_class": self.workload_class,
            "dp": self._dp,
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "pending_tokens": self.pending_tokens(),
            "arena_utilization": round(self.arena_utilization(), 4),
            "reshard_count": self.reshard_count,
            "compile_builds": self.compile_builds,
            "design": self.design(),
            "latency_ms": self.latency_ms(),
            "per_replica": per,
        })
        return merged

    # -- recomposition / design-point reconfiguration -------------------
    def design(self) -> Dict[str, Any]:
        """The group's applied design point: replica 0's engine knobs
        (replicas share one design) plus the replica count."""
        d = dict(self._replicas[0].engine.design())
        d["dp"] = self._dp
        return d

    def sync(self) -> None:
        for rep in self._replicas:
            rep.engine.sync()

    def reshard_to(self, sub: Optional[SubAccelerator]) -> None:
        """Move the whole group onto a new grant (current dp kept).  On one
        card a grant is a share: the group records it and no state moves;
        a mesh grant moves each replica onto its tile."""
        self._granted = sub
        if _mesh_of(sub) is not None:
            for rep in self._replicas:
                rep.engine.reshard_to(replica_submesh(sub, rep.index,
                                                      self._dp))

    def apply(self, sub: Optional[SubAccelerator] = None,
              point: Optional[DesignPoint] = None) -> Dict[str, Any]:
        """Apply a design-point delta group-wide (``None`` fields = keep).

        ``sub`` records the (new) grant: on one card a move migrates no
        state.  ``point.dp`` is consumed here: an unchanged dp fans the
        per-replica knobs out to every member engine; a changed dp runs the
        drain-and-rebalance retune (:meth:`_retarget_dp`), which preserves
        every request's stable rid and exact token stream.  Returns the
        knobs actually applied (replica 0's view, plus ``dp`` when it
        changed)."""
        point = point if point is not None else DesignPoint(cus=0)
        granted = sub if sub is not None else self._granted
        dp = self._target_dp(granted, point)
        eng_point = dataclasses.replace(point, dp=None)
        if dp != self._dp:
            applied = self._retarget_dp(granted, dp, eng_point)
            applied["dp"] = dp
        else:
            applied = {}
            for rep in self._replicas:
                tile = (replica_submesh(granted, rep.index, dp)
                        if sub is not None else None)
                out = rep.engine.apply(tile, eng_point)
                if rep.index == 0:
                    applied = out
        self._granted = granted
        return applied

    def _retarget_dp(self, granted, dp: int,
                     eng_point: DesignPoint) -> Dict[str, Any]:
        """Change the replica count live: drain, re-tile, rebalance.

        Retiring replicas are stripped of ALL work (live slots exported as
        exact host cache blocks, queues handed back) and their finished
        records / telemetry harvested; surviving replicas give up their
        queues too, then retune with their slot pools pre-grown to fit
        planned adoptions; growth replicas are taken from the ones
        ``warm_compile`` staged, or built fresh.  Orphaned live requests
        are then adopted least-loaded-first via exact cache-row copies
        (bit-identical streams — never re-prefilled) and queues
        redistribute by the same order, every request keeping its stable
        group rid."""
        keep, retire = self._replicas[:dp], self._replicas[dp:]
        span_t0, span_src = time.perf_counter(), self._dp
        live: List[Tuple[int, Any, Any]] = []
        queued: List[Tuple[int, Any]] = []
        for rep in retire:
            l_reqs, q_reqs = rep.engine.evacuate()
            live.extend((rep.to_group[r.rid], r, blk) for r, blk in l_reqs)
            queued.extend((rep.to_group[r.rid], r) for r in q_reqs)
            for erid, v in rep.engine.results().items():
                if erid in rep.to_group:
                    self._retired_results[rep.to_group[erid]] = v
            self._retired_builds += rep.engine.compile_builds
            self._retired_reshards += rep.engine.reshard_count
            self._retired_preempts += rep.engine.preempt_count
            if rep.obs is not None:
                # histograms observed by the retiring replica stay in the
                # tenant's merged view (parallel to results/builds above)
                self._retired_metrics.merge(rep.obs.registry)
        for rep in keep:
            queued.extend((rep.to_group[r.rid], r)
                          for r in rep.engine.export_queued())
        # plan live adoptions before any engine changes: least-loaded
        # target first, replica-index tie-break (deterministic)
        occupancy = {i: (keep[i].engine.active_count if i < len(keep) else 0)
                     for i in range(dp)}
        placed: Dict[int, List] = {i: [] for i in range(dp)}
        for item in live:
            i = min(range(dp),
                    key=lambda j: (occupancy[j] + len(placed[j]), j))
            placed[i].append(item)
        applied: Dict[str, Any] = {}
        reps: List[_Replica] = []
        staged, self._staged = self._staged, {}
        for i in range(dp):
            tile = replica_submesh(granted, i, dp)
            if i < len(keep):
                rep = keep[i]
                need = rep.engine.active_count + len(placed[i])
                slots = (eng_point.slots if eng_point.slots is not None
                         else rep.engine.design()["slots"])
                out = rep.engine.apply(tile, dataclasses.replace(
                    eng_point, slots=max(slots, need, 1)))
                if i == 0:
                    applied = out
            else:
                rep = staged.get(i)
                if rep is None:
                    rep_obs = self._obs.fresh()
                    rep = _Replica(self._build_replica(eng_point, tile,
                                                       obs=rep_obs),
                                   obs=rep_obs)
                rep.engine.apply(tile, DesignPoint(cus=0, slots=max(
                    rep.engine.design()["slots"], len(placed[i]), 1)))
            rep.index = i
            reps.append(rep)
        self._replicas, self._dp = reps, dp
        for i, items in placed.items():
            rep = reps[i]
            for grid, req, block in items:
                rep.to_group[rep.engine.adopt_request(req, block)] = grid
        for grid, req in queued:
            rep = min(reps, key=lambda r: (r.engine.pending_tokens(),
                                           r.engine.queue_depth, r.index))
            rep.to_group[rep.engine.adopt_queued(req)] = grid
        if self._obs.enabled:
            self._obs.tracer.record(
                "dp_rebalance", span_t0, time.perf_counter(),
                {"src": span_src, "dst": dp, "moved": len(live),
                 "requeued": len(queued)})
        return applied

    def _build_replica(self, eng_point: DesignPoint,
                       tile: Optional[SubAccelerator] = None,
                       obs: Optional[Telemetry] = None) -> Engine:
        """A fresh member engine at the group's design (dp growth), on the
        shared parameters; on a mesh, on its ``tile`` under the group's
        rules, at the group's TP degree."""
        d0 = self._replicas[0].engine.design()
        slots = (eng_point.slots if eng_point.slots is not None
                 else d0["slots"])
        cfg = dataclasses.replace(self._serve_cfg, max_slots=max(slots, 1))
        mesh = _mesh_of(tile)
        eng = build_engine(self._wclass, self._model, self._params, cfg,
                           exec_cache=self._exec, obs=obs, mesh=mesh,
                           rules=self._rules if mesh is not None else None)
        tp = eng_point.tp if eng_point.tp is not None else d0["tp"]
        if mesh is not None and tp is not None:
            eng.apply(None, DesignPoint(cus=0, tp=tp))
        return eng

    def warm_compile(self, sub: Optional[SubAccelerator],
                     point: Optional[DesignPoint] = None) -> int:
        """Build a candidate design point's steps ahead for every replica
        of it (``point.dp``, defaulting to the live dp): the live replicas
        warm their own pools, and the replicas a dp growth would add are
        built and warmed now, staged for the retune to take over.  Returns
        the cold builds performed."""
        point = point if point is not None else DesignPoint(cus=0)
        granted = sub if sub is not None else self._granted
        dp = self._target_dp(granted, point)
        eng_point = dataclasses.replace(point, dp=None)
        built = 0
        mesh = _mesh_of(granted) is not None
        for i in range(dp):
            tile = replica_submesh(granted, i, dp) if mesh else None
            if i < len(self._replicas):
                built += self._replicas[i].engine.warm_compile(tile,
                                                               eng_point)
                continue
            rep = self._staged.get(i)
            if rep is None or (eng_point.slots is not None and
                               rep.engine.design()["slots"]
                               != eng_point.slots):
                rep_obs = self._obs.fresh()
                rep = _Replica(self._build_replica(eng_point, tile,
                                                   obs=rep_obs),
                               obs=rep_obs)
                self._staged[i] = rep
            built += rep.engine.warm_compile(tile)
        return built


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class ComposedServer:
    """Multi-tenant serving on one composed card with live, delta
    recomposition between decode steps.

    Tenants are a mixed fleet: each runs the engine of its workload class
    (transformer decode / SSM recurrent decode), and the policy prices
    each class by its bound resource.  All engines share one fabric-level
    executable cache (each entry belongs to one engine's pool).

    With a two-stage :class:`AnalyticalPolicy` (the default) the fabric
    runs the paper's DSE in the serving loop: each decide tick it builds
    per-tenant :class:`TenantObservation` records (``observe``), the policy
    returns Stage-1-optimal design points per tenant (CUs + replica count
    + slots), and ``recompose`` applies the deltas live — a CU move
    records the tenant's new share, knob changes go through
    ``Engine.apply`` (a changed ``dp`` triggers the ReplicaGroup's
    drain-and-rebalance).

    num_cus: logical CUs the card is composed of (the policy's ``platform``
        should be ``per_cu(H100_SXM, num_cus)``, the default's N is 8).
    mesh: a ``DeviceMesh`` to compose instead of one card: its model-dim
        columns are the CUs (``num_cus`` is ignored), and every rank of
        its process group builds the server and calls it in the same
        order; a policy built on its default platform prices a CU as one
        GPU on ``H100_NVLINK``, and the mesh's first rank takes the
        decisions (module docstring).
    tp: on a mesh, shard each tenant's engine over its sub-mesh with
        ``serve_engine_rules`` (off: whole on each of its ranks).
    device: the card (``cuda`` by default; ``cpu`` runs the plain path).
    params: optional ``{tenant: param tree}`` (e.g. bridged from the JAX
        package); without it a tenant initialises its weights from
        ``torch.Generator(device).manual_seed(spec.seed)``.
    warm: capture a target composition's decode graphs before committing a
        recomposition, so the first post-move step captures nothing.
    prewarm_async: warm candidate compositions in a background thread while
        the old composition keeps serving; the switch commits on a later
        autoscale tick once the graphs are ready.  Idle decide intervals
        additionally prewarm the policy's runner-up split speculatively.
    """

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 num_cus: int = DEFAULT_CUS, device: DeviceLike = None,
                 params: Optional[Mapping[str, Any]] = None,
                 policy: Optional[AnalyticalPolicy] = None,
                 decide_every: int = 4, warm: bool = True,
                 prewarm_async: bool = False, telemetry: bool = True,
                 events_cap: int = 256, slo_preempt: bool = True,
                 mesh=None, tp: bool = True):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = serve_engine_rules() if mesh is not None and tp \
            else None
        # multi-controller: the rank that takes the mesh's decisions (None
        # on one card) and the gloo group they cross on (host objects: no
        # device copy, no sync of the card), the process group of the
        # background warm-up, and the broadcasts' seconds (the last 1024)
        self._root: Optional[int] = None
        self._decision_group = None
        self._warm_group = None
        self._agreements = 0
        self._agree_seconds: "collections.deque[float]" = \
            collections.deque(maxlen=1024)
        if mesh is not None:
            import torch.distributed as dist

            self.composer = MeshComposer(mesh)
            self._root = int(mesh.mesh.flatten()[0])
            self._decision_group = dist.new_group(backend="gloo")
            if prewarm_async:
                self._warm_group = dist.new_group()
            if policy is not None and policy.default_platform:
                policy.use_platform(H100_NVLINK)
        else:
            self.composer = CUComposer(num_cus, self.device)
        self.policy = policy
        self.decide_every = decide_every
        self.warm = warm
        self.prewarm_async = prewarm_async
        self.specs = {t.name: t for t in tenants}
        # fabric-wide telemetry: one tracer for every span in the stack, a
        # fabric-level registry for step/SLO histograms, and the
        # predicted-vs-measured ledger.  telemetry=False swaps in a
        # disabled handle; token streams are the same either way.
        self.obs = Telemetry() if telemetry else Telemetry.off()
        self.ledger = PredictionLedger()
        # recomposition history: bounded — stats() totals survive eviction
        self.events: "collections.deque[RecompositionEvent]" = \
            collections.deque(maxlen=max(int(events_cap), 1))
        self._recompositions = 0
        self._retunes = 0
        self._recompose_seconds_total = 0.0
        self._warm_compile_seconds_total = 0.0
        self._stall_probe: Dict[str, RecompositionEvent] = {}
        self._step_no = 0
        self._tokens_emitted: Dict[str, int] = {t.name: 0 for t in tenants}
        # graph captures made inside the tenants' steps (the serving path)
        self._path_captures: Dict[str, int] = {t.name: 0 for t in tenants}
        # SLO-aware scheduler state: preemptions made on latency grounds,
        # plus the per-tenant observed quantiles (ms) refreshed at decide
        # cadence — the per-step path must not merge histogram registries.
        # slo_preempt=False keeps attainment *reporting* while never
        # preempting.
        self.slo_preempt = slo_preempt
        # on a mesh the SLO pass takes a decision every step, so it is
        # broadcast every step, only while some tenant's SLO is tracked
        self._slo_tracked = slo_preempt and any(
            t.slo is not None and t.slo.tracked() for t in tenants)
        self._slo_preemptions = 0
        self._slo_obs: Dict[Tuple[str, str], float] = {}
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending_prewarm: Optional[
            Tuple[Dict[str, DesignPoint], str, list]] = None
        # speculative runner-up prewarm bookkeeping
        self.speculative_prewarms = 0
        self._spec_warmed: set = set()
        self._spec_futures: List[concurrent.futures.Future] = []

        # initial composition: equal shares, remainder to the first tenants
        n = len(tenants)
        if n > self.composer.num_cus:
            raise ValueError(
                f"{n} tenants need at least {n} CUs; the fabric has "
                f"{self.composer.num_cus}")
        base, extra = divmod(self.composer.num_cus, n)
        sizes = {t.name: base + (1 if i < extra else 0)
                 for i, t in enumerate(tenants)}
        self.subs, _ = self.composer.recompose({}, sizes)

        # fabric-level executable cache: shared across every tenant engine
        self.exec_cache = ExecutableCache(capacity=128)
        self.cfgs: Dict[str, ModelConfig] = {}
        self.classes: Dict[str, str] = {}
        self.src_lens: Dict[str, int] = {}
        self.engines: Dict[str, ReplicaGroup] = {}
        weight_bytes = 0
        for spec in tenants:
            cfg = (get_reduced(spec.arch) if spec.reduced
                   else get_config(spec.arch))
            if spec.layers:
                cfg = dataclasses.replace(cfg, num_layers=spec.layers)
            wclass = (workload_class_of(cfg) if spec.workload == "auto"
                      else spec.workload)
            model = build_model(cfg, self.device)
            if params is not None and spec.name in params:
                tparams = params[spec.name]
            else:
                gen = torch.Generator(device=self.device)
                tparams = model.init(gen.manual_seed(spec.seed))
            weight_bytes += _param_bytes(tparams)
            self.cfgs[spec.name] = cfg
            self.classes[spec.name] = wclass
            if wclass == ENCDEC:
                # prices the per-step cross-attention source-cache read
                self.src_lens[spec.name] = (spec.serve.max_src_len
                                            or spec.serve.max_len)
            self.engines[spec.name] = ReplicaGroup(
                wclass, model, tparams, spec.serve,
                sub=self.subs[spec.name], exec_cache=self.exec_cache,
                obs=self.obs.scoped(tenant=spec.name, wclass=wclass),
                rules=self.rules)
        if self.policy is not None and self.policy.stage1 is not None:
            # a grant's memory bound on slots: its CUs' share of the HBM
            # that every tenant's weights leave free (weights stay
            # resident whatever the grant).  On a mesh a CU is one GPU,
            # each of which keeps every tenant's whole weights (replicas
            # and moves are cut from them), so the bound is per GPU
            hbm = self.policy.platform.hbm_bytes
            if mesh is not None:
                self.policy.stage1.mem_budget_bytes = float(
                    max(hbm - weight_bytes, 0))
            else:
                card = hbm * self.composer.num_cus
                self.policy.stage1.mem_budget_bytes = (
                    max(card - weight_bytes, 0) / self.composer.num_cus)
        # design-key memo for the prediction ledger's measured side (the
        # per-step path must not rebuild design dicts per tenant per step)
        self._design_keys: Dict[str, str] = {}
        self._refresh_design_keys()

    # ------------------------------------------------------------------
    def submit(self, tenant: str, tokens, max_new_tokens: int = 16,
               **kwargs) -> int:
        """Route one request to ``tenant``'s engine; returns its rid.  An
        enc-dec tenant's ``tokens`` is the source: token ids, or a (S,
        d_model) array of precomputed frames; extra keywords pass through
        to the engine's submit (its forced-decoding ``prefix=``)."""
        return self.engines[tenant].submit(tokens, max_new_tokens, **kwargs)

    def sizes(self) -> Dict[str, int]:
        """Current composition: tenant -> CUs held (0 = parked)."""
        return {t: len(self.subs[t].cu_ids) if t in self.subs else 0
                for t in self.engines}

    def loads(self) -> Dict[str, TenantLoad]:
        """Per-tenant load signals sampled from the engines (group-merged
        across replicas)."""
        return {t: TenantLoad(eng.pending_tokens(), eng.queue_depth,
                              eng.active_count, eng.arena_utilization())
                for t, eng in self.engines.items()}

    def observe(self) -> Dict[str, TenantObservation]:
        """Per-tenant :class:`TenantObservation` — the one record
        ``AnalyticalPolicy.decide`` consumes."""
        spaces = self._design_spaces() or {}
        return {t: TenantObservation(
                    pending_tokens=eng.pending_tokens(),
                    queue_depth=eng.queue_depth,
                    active=eng.active_count,
                    arena_utilization=eng.arena_utilization(),
                    wclass=self.classes[t],
                    recent_lengths=eng.recent_lengths(),
                    src_len=self.src_lens.get(t, 0),
                    space=spaces.get(t))
                for t, eng in self.engines.items()}

    # ------------------------------------------------------------------
    def step(self) -> Dict[str, List[Tuple[int, int]]]:
        """One fabric iteration: SLO admission check, then step every
        composed (non-parked) tenant, then maybe recompose.  Returns
        per-tenant emitted (rid, token)."""
        if (self.decide_every > 0
                and self._step_no % self.decide_every == 0):
            self._refresh_slo_observed()
        self._slo_schedule()
        emitted = {}
        for t, eng in self.engines.items():
            if t not in self.subs:
                continue                      # parked: no CUs this interval
            probe = self._stall_probe.pop(t, None)
            busy = eng.has_work
            q0 = eng.queue_depth
            captures = eng.graph_captures
            t0 = time.monotonic()
            out = eng.step()
            if probe is not None:
                # pipelined dispatch returns before the step executes; the
                # probed post-move step covers its device work too
                eng.sync()
            dt = time.monotonic() - t0
            self._path_captures[t] += eng.graph_captures - captures
            if probe is not None:
                probe.post_step_seconds[t] = dt
            elif busy and eng.queue_depth == q0 and self.obs.enabled:
                # decode percentiles only: idle no-op steps would deflate
                # them; admission steps (blocking prefill) and probed
                # full-sync steps would inflate them
                reg = self.obs.registry
                reg.histogram("decode_step_s", tenant=t).observe(dt)
                if out:
                    unit = dt / len(out)
                    reg.histogram("per_token_s", tenant=t).observe(unit)
                    # the ledger's measured side: on the card, the device
                    # time per token of the tenant's last harvested step
                    # (two tenants' steps overlap on the card, so the host
                    # time of a pipelined step is mostly the other's);
                    # off it, the host time as the reference measures it
                    dev = eng.take_step_device()
                    if dev is not None and dev[1]:
                        unit = dev[0] / dev[1]
                    self.ledger.observe(t, self._design_keys[t], unit,
                                        wclass=self.classes[t])
            if self.obs.enabled:
                self.obs.registry.gauge("queue_depth", tenant=t).value = \
                    eng.queue_depth
            self._tokens_emitted[t] += len(out)
            if out:
                emitted[t] = out
        self._step_no += 1
        if (self.policy is not None and self.decide_every > 0
                and self._step_no % self.decide_every == 0):
            self.autoscale()
        return emitted

    # ------------------------------------------------------------------
    # serving-side DSE plumbing (Stage-1 inputs, applied design points)
    # ------------------------------------------------------------------
    def _design_spaces(self) -> Optional[Dict[str, TenantDesignSpace]]:
        """Per-tenant Stage-1 search bounds, snapshotted from the engines
        each decide tick (None when the policy is split-only)."""
        if self.policy is None or self.policy.stage1 is None:
            return None
        out = {}
        for t, eng in self.engines.items():
            d = eng.design()
            arena = eng.arena
            per_slot = (arena.capacity // max(d["slots"], 1)
                        if arena is not None else 0)
            paged = isinstance(arena, PagedArena)
            out[t] = TenantDesignSpace(
                wclass=self.classes[t],
                max_len=eng.cfg.max_len,
                max_src=getattr(eng.replicas[0], "_max_src", 0),
                base_slots=d["slots"],
                base_buckets=tuple(d["buckets"] or ()),
                base_tp=d["tp"],
                base_dp=d.get("dp", 1),
                per_slot_elems=per_slot,
                # TP rules on a mesh (one card, or tp=False: none)
                tp_allowed=self.rules is not None,
                slot_cap=max(eng.cfg.slot_cap, 1),
                dp_cap=max(self.specs[t].dp_cap, 1),
                # SSM archs prefill at exact lengths — no padding for
                # Stage 1 to price on their admission path
                prefill_bucket=(eng.cfg.prefill_bucket
                                if self.cfgs[t].ssm is None else 0),
                use_kernels=eng.cfg.use_kernels,
                # paged KV arenas admit by expected page footprint, not the
                # worst-case slot reservation — Stage 1 prices accordingly
                paged=paged,
                page_rows=arena.page_rows if paged else 0,
                page_elems=arena.page_elems if paged else 0)
        return out

    def _applied_points(self) -> Dict[str, DesignPoint]:
        """The live composition as applied design points (the policy's
        hysteresis baseline; parked tenants carry cus 0)."""
        out = {}
        for t, eng in self.engines.items():
            c = len(self.subs[t].cu_ids) if t in self.subs else 0
            d = eng.design()
            out[t] = DesignPoint(
                cus=c, tp=d["tp"], slots=d["slots"],
                buckets=tuple(d["buckets"]) if d["buckets"] else None,
                dp=d.get("dp", 1))
        return out

    def _refresh_design_keys(self) -> None:
        """Re-memoize each tenant's compact design key for the prediction
        ledger's per-step measured side (construction and every
        recomposition)."""
        for t, eng in self.engines.items():
            cus = len(self.subs[t].cu_ids) if t in self.subs else 0
            self._design_keys[t] = design_key(cus, eng.design())

    def _knob_delta(self, t: str, p: DesignPoint) -> Dict[str, object]:
        """Engine-knob overrides that actually change tenant ``t``'s
        configuration when design point ``p`` commits (None knobs keep; a
        slot shrink clamps at the per-replica live occupancy — streams are
        migrated, never evicted).  Slots compare at the point's replica
        count."""
        eng = self.engines[t]
        d = eng.design()
        out: Dict[str, object] = {}
        dp_now = d.get("dp", 1) or 1
        dp_want = dp_now
        if p.dp is not None:
            dp_want = max(1, min(p.dp, max(p.cus, 1)))
            if dp_want != dp_now:
                out["dp"] = dp_want
        width = max(p.cus // max(dp_want, 1), 1)
        if p.tp is not None:
            want = min(p.tp, width)
            would = min(d["tp"], width) if d["tp"] else width
            if want != would:
                out["tp"] = p.tp
        if p.slots is not None:
            want_s = max(p.slots, -(-eng.active_count // max(dp_want, 1)))
            if want_s != d["slots"]:
                out["slots"] = want_s
        if p.buckets is not None and d["buckets"] is not None \
                and tuple(p.buckets) != tuple(d["buckets"]):
            out["buckets"] = tuple(p.buckets)
        return out

    @staticmethod
    def _delta_point(p: DesignPoint,
                     knobs: Optional[Dict[str, object]]) -> DesignPoint:
        """A knob delta as the DesignPoint handed to ``Engine.apply`` /
        ``warm_compile`` (absent knobs become None = keep)."""
        kn = knobs or {}
        return DesignPoint(cus=p.cus, tp=kn.get("tp"),
                           slots=kn.get("slots"),
                           buckets=kn.get("buckets"), dp=kn.get("dp"))

    def _no_change(self, points: Mapping[str, DesignPoint]) -> bool:
        """True when applying ``points`` would change nothing: same CU
        split AND no engine-knob delta on any composed tenant."""
        sizes = {t: p.cus for t, p in points.items() if p.cus > 0}
        if sizes != self._normalized(self.sizes()):
            return False
        return all(not self._knob_delta(t, p) for t, p in points.items()
                   if p.cus > 0)

    def autoscale(self) -> Optional[RecompositionEvent]:
        """Consult the policy; apply the recomposition it asks for.

        With ``prewarm_async`` the switch is two-phase: kick background
        warm-ups for the chosen composition (at its target design points),
        keep serving on the current one, and commit on a later tick once
        every graph is captured.  On a mesh the first rank decides both
        (its policy's decision, its warm-up's readiness) and every rank
        applies what it decided."""
        if self._pending_prewarm is not None:
            target, reason, futures = self._pending_prewarm
            ready = all(f.done() for f in futures)
            if self.mesh is not None:
                ready = self._agree(lambda: ready)
            if not ready:
                return None               # still warming in the background
            self._pending_prewarm = None
            for f in futures:
                f.result()                # surface background build errors
            if self._no_change(target):
                return None
            return self.recompose(target, reason=reason, overlapped=True)

        if self.mesh is not None:
            target, reason, ru, predicted = self._agree(self._decide)
            self.policy.runner_up, self.policy.predicted = ru, predicted
        else:
            target, reason, _, _ = self._decide()
        target = {t: p for t, p in target.items() if p.cus > 0}
        if self._no_change(target):
            # idle decide interval: nothing committed — speculatively warm
            # the policy's runner-up design so the *next* plausible switch
            # is already captured when its gain clears hysteresis
            self._speculative_prewarm()
            return None
        if self.warm and self.prewarm_async:
            futures = self._warm_design(target)
            self._pending_prewarm = (target, reason, futures)
            return None
        return self.recompose(target, reason=reason)

    def _decide(self):
        """The policy's decision on this rank: (target, reason, runner-up,
        predicted makespans)."""
        with self.obs.span("decide", step=self._step_no):
            target, reason = self.policy.decide(
                self.observe(), self.cfgs, self._applied_points(),
                self.composer.num_cus)
        return target, reason, self.policy.runner_up, self.policy.predicted

    def _agree(self, decide):
        """``decide()`` as the mesh's first rank takes it, on every rank:
        it decides and broadcasts, the others receive (every rank calls
        this together).  Decisions that read a rank's own clock are taken
        so, and the broadcasts' count and time are kept (``stats()``)."""
        import torch.distributed as dist

        box = [decide() if dist.get_rank() == self._root else None]
        t0 = time.perf_counter()
        dist.broadcast_object_list(box, src=self._root,
                                   group=self._decision_group)
        self._agreements += 1
        self._agree_seconds.append(time.perf_counter() - t0)
        return box[0]

    def _warm_design(self, points: Mapping[str, DesignPoint]) -> list:
        """Submit background warm-ups for a candidate design — every
        tenant a knob delta would touch, each warmed at its target design
        point's overrides (a CU move alone changes nothing a step reads on
        one card; on a mesh a moved tenant is warmed too, its params moved
        to its new ranks).  The candidate's sub-meshes are made here, on
        the serving thread; the warm-up's collectives run on the fabric's
        warm-up group.  Returns the futures."""
        new_subs, delta = self.composer.recompose(
            self.subs, {t: p.cus for t, p in points.items()})
        moved = set(delta.moved + delta.admitted) if self.mesh is not None \
            else set()
        jobs = []
        for t in sorted(t for t, p in points.items()
                        if self._knob_delta(t, p) or t in moved):
            pt = self._delta_point(points[t], self._knob_delta(t, points[t]))
            self.engines[t].make_meshes(new_subs[t], pt)
            jobs.append(self._pool().submit(self._warm_job, t, new_subs[t],
                                            pt))
        return jobs

    def _warm_job(self, t: str, sub, point: DesignPoint) -> int:
        with part.collectives_on(self._warm_group):
            return self.engines[t].warm_compile(sub, point)

    def _settle_warm(self) -> None:
        """Wait for every background warm-up in flight (on a mesh, before
        a recomposition moves an engine that one may be moving too)."""
        futures = list(self._spec_futures)
        if self._pending_prewarm is not None:
            futures += self._pending_prewarm[2]
        for f in futures:
            f.result()

    def _speculative_prewarm(self) -> None:
        """Warm the runner-up candidate design in the background (gated on
        ``prewarm_async``; the same single-worker pool as a committed
        prewarm).  Each distinct runner-up — keyed on the FULL design
        point — is warmed once."""
        # surface errors from (and drop) finished speculative warm-ups
        pending = []
        for f in self._spec_futures:
            if f.done():
                f.result()
            else:
                pending.append(f)
        self._spec_futures = pending
        ru = self.policy.runner_up if self.policy is not None else None
        if not (self.warm and self.prewarm_async and ru):
            return
        ru = {t: p for t, p in ru.items() if p.cus > 0}
        if not ru or self._no_change(ru):
            return
        key = tuple(sorted((t, p.cus, p.tp, p.slots, p.dp,
                            tuple(p.buckets or ())) for t, p in ru.items()))
        if key in self._spec_warmed:
            return
        if len(self._spec_warmed) > 64:      # long-lived fabric: re-warm ok
            self._spec_warmed.clear()
        futures = self._warm_design(ru)
        if not futures:
            return
        self._spec_warmed.add(key)
        self.speculative_prewarms += 1
        self._spec_futures.extend(futures)

    @staticmethod
    def _normalized(sizes: Mapping[str, int]) -> Dict[str, int]:
        return {t: s for t, s in sizes.items() if s > 0}

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="prewarm")
        return self._executor

    def recompose(self, target_sizes: Mapping[str, object], *,
                  reason: str = "manual",
                  overlapped: bool = False) -> RecompositionEvent:
        """Live recomposition: grow/shrink/admit/park tenants AND apply
        per-tenant design-point deltas (DSE Stage-1 knobs).

        ``target_sizes`` maps tenant -> CU count (int) or DesignPoint.
        Unchanged tenants keep their CU ids; a tenant whose knobs changed
        with its CU set intact is *retuned* in place (``Engine.apply``:
        live slots migrate inside the resize, and a dp retune rebalances
        them across the new replica set).  With warming on, the target
        design points' graphs are captured before anything changes, so the
        post-move step captures nothing.  On one card a move alone changes
        nothing a step reads (the pool, its graphs and the weights stay), so
        only tenants whose knobs change are warmed; on a mesh every moved
        tenant is (its params reach the new ranks then, its KV at the
        move)."""
        rc_t0 = time.perf_counter()
        if self.mesh is not None:
            self._settle_warm()
        before = self.sizes()
        points = {t: (v if isinstance(v, DesignPoint)
                      else DesignPoint(cus=int(v)))
                  for t, v in target_sizes.items()}
        sizes = {t: p.cus for t, p in points.items()}
        new_subs, delta = self.composer.recompose(self.subs, sizes)
        knobs = {t: self._knob_delta(t, p) for t, p in points.items()
                 if p.cus > 0}
        moved = delta.moved + delta.admitted
        retuned = tuple(t for t in knobs
                        if knobs[t] and t not in moved)
        touched = moved + retuned
        warm_s, warm_builds = 0.0, 0
        if self.warm:
            w0 = time.monotonic()
            for t in (t for t in touched
                      if knobs.get(t) or self.mesh is not None):
                warm_builds += self.engines[t].warm_compile(
                    new_subs[t],
                    self._delta_point(points[t], knobs.get(t)))
            warm_s = time.monotonic() - w0
        t0 = time.monotonic()
        applied: Dict[str, Dict] = {}
        for t in touched:
            eng = self.engines[t]
            with self.obs.span("migrate", tenant=t,
                               kind="move" if t in moved else "retune"):
                out = eng.apply(new_subs[t] if t in moved else None,
                                self._delta_point(points[t], knobs.get(t)))
                if out:
                    applied[t] = out
                eng.sync()
        self.subs = new_subs
        # the committed composition changes grants, so a previously
        # prewarmed runner-up design may need warming again
        self._spec_warmed.clear()
        seconds = time.monotonic() - t0
        event = RecompositionEvent(
            step=self._step_no, sizes_before=before, sizes_after=self.sizes(),
            moved=moved, unchanged=delta.unchanged,
            parked=delta.evicted, seconds=seconds, reason=reason,
            retuned=retuned, design=applied,
            warm_compile_seconds=warm_s, warm_builds=warm_builds,
            overlapped=overlapped)
        for t in touched:
            self._stall_probe[t] = event
        self.events.append(event)
        # fold-before-evict totals: the deque above is bounded
        self._recompositions += 1
        self._retunes += len(retuned)
        self._recompose_seconds_total += seconds
        self._warm_compile_seconds_total += warm_s
        # predicted-vs-measured accounting: refresh the per-tenant design
        # keys for the committed composition, then record each touched
        # tenant's Stage-1 predicted per-unit cost next to the measured
        # per-step histogram that accumulates under the same key
        self._refresh_design_keys()
        for t in touched:
            p = points.get(t)
            if p is not None:
                self.ledger.commit(t, self.classes[t],
                                   self._design_keys[t], p.cost)
        if self.obs.enabled:
            self.obs.tracer.record(
                "recompose", rc_t0, time.perf_counter(),
                {"reason": reason, "moved": list(moved),
                 "retuned": list(retuned), "parked": list(delta.evicted),
                 "warm_builds": warm_builds},
                cat="recompose")
            self.obs.inc("recompositions")
        return event

    def unify(self, tenant: str, *, reason: str = "unify"
              ) -> RecompositionEvent:
        """The monolithic composition: the whole card (or mesh) for one
        tenant."""
        return self.recompose({tenant: self.composer.num_cus}, reason=reason)

    # ------------------------------------------------------------------
    def pending(self) -> int:
        """Total owed work units across tenants."""
        return sum(ld.pending_tokens for ld in self.loads().values())

    def drain(self, max_steps: int = 10_000) -> Dict[str, Dict[int, List[int]]]:
        """Step until every tenant's queue, slots and in-flight dispatches
        are empty; returns per-tenant {rid: tokens} for all requests seen."""
        for _ in range(max_steps):
            busy = [t for t, eng in self.engines.items() if eng.has_work]
            if not busy:
                break
            if any(t not in self.subs for t in busy) and self.policy is None:
                # no policy to re-admit a parked tenant: give it CUs back
                self.recompose({t: 0 for t in self.engines} |
                               {t: self.composer.num_cus // max(len(busy), 1)
                                for t in busy}, reason="drain")
            self.step()
        return self.results()

    def results(self) -> Dict[str, Dict[int, List[int]]]:
        """Per-tenant ``snapshot()``: every request seen -> emitted
        tokens."""
        return {t: eng.snapshot() for t, eng in self.engines.items()}

    def decode_step_ms(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant decode step latency percentiles (milliseconds), read
        from the fabric registry's ``decode_step_s{tenant}`` histograms
        (empty with telemetry off)."""
        out = {}
        for t in self.engines:
            h = self.obs.registry.merged_histogram("decode_step_s", tenant=t)
            if h.count == 0:
                continue
            out[t] = {"p50": round(h.quantile(0.5) * 1e3, 3),
                      "p95": round(h.quantile(0.95) * 1e3, 3),
                      "n": h.count}
        return out

    # ------------------------------------------------------------------
    # telemetry export surface (repro_torch.obs)
    # ------------------------------------------------------------------
    def metrics(self) -> MetricsRegistry:
        """One merged registry across the whole stack: the fabric's own
        step/SLO histograms plus every tenant engine's per-replica
        registries (retired dp replicas included), with the shared
        executable cache folded in as gauges."""
        merged = MetricsRegistry()
        merged.merge(self.obs.registry)
        for eng in self.engines.values():
            merged.merge(eng.metrics())
        snap = self.exec_cache.snapshot()
        for k, v in snap.items():
            merged.gauge(f"exec_cache_{k}").set(float(v))
        merged.counter("recompositions_total").inc(self._recompositions)
        merged.counter("retunes_total").inc(self._retunes)
        return merged

    def metrics_snapshot(self) -> Dict[str, object]:
        """JSON-friendly dump of :meth:`metrics`."""
        return self.metrics().snapshot()

    def dump_trace(self, path: str) -> str:
        """Write the span ring buffer as Chrome/Perfetto trace-event JSON;
        returns the path written."""
        return self.obs.tracer.dump(path)

    # ------------------------------------------------------------------
    # SLO-aware scheduling
    # ------------------------------------------------------------------
    def _refresh_slo_observed(self) -> None:
        """Re-sample each SLO-tracked tenant's observed p99s (ms) from the
        obs histograms, at decide cadence."""
        for t, eng in self.engines.items():
            slo = self.specs[t].slo
            if slo is None or not slo.tracked():
                continue
            if slo.ttft_p99_ms > 0:
                h = eng.metrics().merged_histogram("ttft_s")
                if h.count:
                    self._slo_obs[(t, "ttft_p99_ms")] = \
                        h.quantile(0.99) * 1e3
            if slo.per_token_p99_ms > 0:
                h = self.obs.registry.merged_histogram("per_token_s",
                                                       tenant=t)
                if h.count:
                    self._slo_obs[(t, "per_token_p99_ms")] = \
                        h.quantile(0.99) * 1e3

    def _slo_preempt(self, t: str, why: str) -> bool:
        rid = self.engines[t].preempt_one()
        if rid is None:
            return False
        self._slo_preemptions += 1
        if self.obs.enabled:
            self.obs.inc("slo_preemptions")
            self.obs.inc(f"slo_preemptions_{why}")
        return True

    def _slo_schedule(self) -> None:
        """The SLO-aware admission/preemption pass, run before each fabric
        step.

        TTFT protection: a tenant whose head-of-line queue wait has burned
        half its p99 TTFT budget (a quarter once its *observed* TTFT p99
        is already over target) gets its slackest live stream preempted,
        so the freed slot/pages admit the waiting request in this very
        step's ``_admit``.  Per-token protection: a tenant whose observed
        per-token p99 breached target sheds one stream, at most one parked
        at a time.  Preemption saves exact device state; the victim
        re-admits later and continues bit-identically.  On a mesh the
        signals, which read clocks, are the first rank's (``_agree``)."""
        if not self.slo_preempt:
            return
        if self.mesh is None:
            signals = self._slo_signals()
        elif self._slo_tracked:
            signals = self._agree(self._slo_signals)
        else:
            return
        for t, (ttft, per_token) in signals.items():
            if ttft and self._slo_preempt(t, "ttft"):
                continue
            if per_token:
                self._slo_preempt(t, "per_token")

    def _slo_signals(self) -> Dict[str, Tuple[bool, bool]]:
        """Per composed SLO-tracked tenant: (its head-of-line wait burns
        its TTFT budget, its observed per-token p99 breached target) — the
        SLO pass's decision, read from this rank's clocks."""
        out: Dict[str, Tuple[bool, bool]] = {}
        now = time.perf_counter()
        for t, eng in self.engines.items():
            if t not in self.subs:
                continue                     # parked tenant: no CUs at all
            slo = self.specs[t].slo
            if slo is None or not slo.tracked():
                continue
            ttft = False
            if slo.ttft_p99_ms > 0 and eng.queue_depth > 0:
                breached = (self._slo_obs.get((t, "ttft_p99_ms"), 0.0)
                            > slo.ttft_p99_ms)
                frac = 0.25 if breached else 0.5
                ttft = (eng.queue_head_wait_s(now) * 1e3
                        >= frac * slo.ttft_p99_ms)
            per_token = (slo.per_token_p99_ms > 0 and eng.active_count > 1
                         and eng.preempted_depth == 0
                         and self._slo_obs.get((t, "per_token_p99_ms"), 0.0)
                         > slo.per_token_p99_ms)
            if ttft or per_token:
                out[t] = (ttft, per_token)
        return out

    def slo_attainment(self) -> Dict[str, object]:
        """Per-tenant SLO attainment: for every declared target, the
        fraction of observed TTFTs / per-token latencies at or under it
        and whether that fraction meets the target's own percentile, plus
        the preemption counters the scheduler spent getting there."""
        merged = self.metrics()
        tenants: Dict[str, Dict[str, object]] = {}
        for t, eng in self.engines.items():
            slo = self.specs[t].slo
            if slo is None or not slo.tracked():
                continue
            row: Dict[str, object] = {
                "class": self.classes[t],
                "preemptions": int(eng.preempt_count),
                "parked": int(eng.preempted_depth),
            }
            for metric, name, src, targets in (
                    ("ttft", "ttft_s", merged,
                     ((0.50, slo.ttft_p50_ms), (0.99, slo.ttft_p99_ms))),
                    ("per_token", "per_token_s", self.obs.registry,
                     ((0.50, slo.per_token_p50_ms),
                      (0.99, slo.per_token_p99_ms)))):
                if not any(tgt > 0 for _, tgt in targets):
                    continue
                h = src.merged_histogram(name, tenant=t)
                ent: Dict[str, object] = {"n": h.count}
                for q, tgt in targets:
                    if tgt <= 0:
                        continue
                    att = (h.fraction_below(tgt * 1e-3)
                           if h.count else 0.0)
                    ent[f"p{int(q * 100)}"] = {
                        "target_ms": tgt,
                        "observed_ms": (round(h.quantile(q) * 1e3, 3)
                                        if h.count else None),
                        "attainment": round(att, 4),
                        "met": bool(h.count) and att + 1e-12 >= q,
                    }
                row[metric] = ent
            tenants[t] = row
        return {"tenants": tenants,
                "slo_preemptions": self._slo_preemptions}

    def slo_summary(self) -> Dict[str, object]:
        """Per-tenant serving SLO percentiles (milliseconds): TTFT,
        per-token latency, decode-step latency and queue wait, plus the
        predicted-vs-measured aggregate.  TTFT/queue-wait come from the
        engines' merged registries; per-token and step latency from the
        fabric-level filtered histograms (steady-state decode only)."""
        merged = self.metrics()
        per_tenant: Dict[str, Dict[str, object]] = {}
        for t in self.engines:
            row: Dict[str, object] = {"class": self.classes[t]}
            for name, label in (("ttft_s", "ttft_ms"),
                                ("queue_wait_s", "queue_wait_ms"),
                                ("per_token_s", "per_token_ms"),
                                ("decode_step_s", "decode_step_ms")):
                src = (self.obs.registry if name in
                       ("decode_step_s", "per_token_s") else merged)
                h = src.merged_histogram(name, tenant=t)
                if h.count == 0:
                    continue
                row[label] = {"p50": round(h.quantile(0.5) * 1e3, 4),
                              "p99": round(h.quantile(0.99) * 1e3, 4),
                              "n": h.count}
            per_tenant[t] = row
        return {"tenants": per_tenant,
                "predicted_vs_measured":
                    self.ledger.summary()["aggregate"]}

    def stats(self) -> Dict[str, object]:
        """Fabric-wide telemetry: per-tenant emitted units and classes,
        recomposition timings (seconds), per-tenant cold builds and graph
        captures on the serving path, shared-cache hit counts, speculative
        prewarms, decode step latency percentiles (ms), predicted-vs-
        measured accounting and the current composition.  Counts and
        totals come from fold counters, not the bounded ``events``
        deque."""
        return {
            "steps": self._step_no,
            "workload_classes": dict(self.classes),
            "tokens_emitted": dict(self._tokens_emitted),
            # applied design points (the serving DSE's Stage-1 knobs)
            "design_points": {
                t: {"cus": len(self.subs[t].cu_ids) if t in self.subs else 0,
                    "tp": d["tp"], "slots": d["slots"],
                    "buckets": list(d["buckets"]) if d["buckets"] else None,
                    "dp": d.get("dp", 1)}
                for t, d in ((t, eng.design())
                             for t, eng in self.engines.items())},
            "retunes": self._retunes,
            "recompositions": self._recompositions,
            "recompose_seconds": round(self._recompose_seconds_total, 4),
            "warm_compile_seconds": round(self._warm_compile_seconds_total,
                                          4),
            "recompose_seconds_recent": [round(e.seconds, 4)
                                         for e in self.events],
            "preemptions": {t: int(eng.preempt_count)
                            for t, eng in self.engines.items()},
            "slo_preemptions": self._slo_preemptions,
            "compile_builds": {t: eng.compile_builds
                               for t, eng in self.engines.items()},
            "serving_captures": dict(self._path_captures),
            "shared_exec_cache": {"builds": self.exec_cache.builds,
                                  "hits": self.exec_cache.hits},
            "speculative_prewarms": self.speculative_prewarms,
            # on a mesh: decisions broadcast from its first rank, and the
            # broadcasts' time over the last 1024 (on the first rank the
            # broadcast alone; on the others with their wait for its
            # decision)
            "mesh_decisions": {
                "broadcasts": self._agreements,
                "seconds": round(sum(self._agree_seconds), 6),
                "p50_ms": (round(statistics.median(self._agree_seconds)
                                 * 1e3, 4) if self._agree_seconds
                           else None)},
            "decode_step_ms": self.decode_step_ms(),
            "predicted_vs_measured": self.ledger.summary(),
            "composition": {t: list(self.subs[t].cu_ids)
                            for t in self.subs},
        }
