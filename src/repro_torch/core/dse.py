"""Two-stage DSE driver (paper §3.1, Fig. 6).

Stage 1 (Runtime Parameter Optimizer): brute-force per-layer runtime
parameters under FMU/CU constraints -> mode tables (repro_torch.core.modes).
Stage 2 (Schedule Optimizer): resource-constrained DAG scheduling over the
mode tables — exact MILP-equivalent branch-and-bound for small task sets,
the GA heuristic for large ones (``solver='auto'`` switches on problem
size, reproducing the paper's guidance in §4.4).

The result carries the ExecutionPlan consumed by the code generator
(instruction streams) and by the mesh composer.

The *serving-side* incarnation of the same two-stage split lives in the
reference's ``serve/dse.py`` (not ported yet): there Stage 1 optimizes one
tenant engine's runtime parameters (TP degree, slot count, bucket ladder)
per candidate CU grant with the analytical model, and Stage 2 is the
recomposition policy's split search over those Stage-1-optimal
:class:`DesignPoint` memos.  The
``DesignPoint`` record is defined here because it is the shared currency
between the two stages — the offline driver's mode tables play the same
role for the schedule optimizer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

from repro_torch.common.platform import PlatformProfile, VCK190
from repro_torch.configs.paper_workloads import MMWorkload
from repro_torch.core import modes as modes_lib
from repro_torch.core.analytical import AccelConfig
from repro_torch.core.ga import GAConfig, GAResult, solve_ga
from repro_torch.core.milp import Result as MILPResult
from repro_torch.core.milp import solve_exact
from repro_torch.core.schedule import Schedule, ScheduleProblem, validate

AUTO_EXACT_MAX_NODES = 12        # |layers| x |modes| budget for exact solver
AUTO_EXACT_MAX_MODES = 8


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One workload's optimized runtime configuration on a ``cus``-CU
    sub-accelerator — Stage 1's output, Stage 2's search atom.

    On the serving fabric the knobs are the tenant engine's runtime
    parameters; ``None`` means "keep the engine's current setting" (used
    by the split-only policy mode, which optimizes nothing per tenant):

    * ``tp``      — tensor-parallel degree over the sub-mesh (<= cus; the
      analytical all-reduce cost can make ``tp < cus`` optimal);
    * ``dp``      — data-parallel replica count inside the grant: the grant
      is tiled into ``dp`` disjoint ``tp``-wide slices, each running an
      independent engine replica (Herald-style configuration tiling; the
      serving fabric's ``ReplicaGroup`` owns the replicas);
    * ``slots``   — concurrent decode/SSM slots **per replica** (batch per
      step, priced via ``batch`` in the analytical step cost,
      memory-feasibility-bounded by one replica slice's HBM);
    * ``buckets`` — padded-length program ladder for encode phases
      (encoder / enc-dec tenants), chosen from observed job lengths.

    ``cost`` is the predicted seconds per unit of owed work (decode step /
    prompt token) at this design point — what Stage 2's makespan minimizes.
    """

    cus: int
    tp: Optional[int] = None
    slots: Optional[int] = None
    buckets: Optional[Tuple[int, ...]] = None
    dp: Optional[int] = None
    cost: float = 0.0

    def knobs(self) -> dict:
        """The non-default engine knobs this point pins (for telemetry)."""
        out = {}
        if self.tp is not None:
            out["tp"] = self.tp
        if self.dp is not None:
            out["dp"] = self.dp
        if self.slots is not None:
            out["slots"] = self.slots
        if self.buckets is not None:
            out["buckets"] = list(self.buckets)
        return out


def tp_candidates(cus: int) -> Tuple[int, ...]:
    """Candidate tensor-parallel degrees on a ``cus``-CU grant: powers of
    two up to the grant, plus the grant itself (the full-mesh default)."""
    if cus <= 0:
        return ()
    out = []
    p = 1
    while p < cus:
        out.append(p)
        p *= 2
    out.append(cus)
    return tuple(out)


def dp_candidates(cus: int, tp: int) -> Tuple[int, ...]:
    """Candidate data-parallel replica counts for ``tp``-wide replicas on a
    ``cus``-CU grant: powers of two plus the maximum packing, subject to
    ``tp * dp <= cus`` (replica slices are disjoint)."""
    if cus <= 0 or tp <= 0 or tp > cus:
        return ()
    cap = cus // tp
    out = []
    p = 1
    while p < cap:
        out.append(p)
        p *= 2
    out.append(cap)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class PlannedLayer:
    layer: int
    name: str
    mkn: Tuple[int, int, int]
    mode_fmus: int
    mode_cus: int
    tile: Tuple[int, int, int]
    start: float
    end: float
    fmu_ids: Tuple[int, ...]
    cu_ids: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    workload: str
    layers: Tuple[PlannedLayer, ...]
    makespan: float

    def throughput_flops(self, total_flops: float) -> float:
        return total_flops / self.makespan if self.makespan else 0.0

    def time_slots(self) -> List[Tuple[float, List[PlannedLayer]]]:
        """Group layers by start time — concurrent groups run on disjoint
        CU sets (the composed-accelerator view)."""
        slots = {}
        for pl in self.layers:
            slots.setdefault(pl.start, []).append(pl)
        return sorted(slots.items())


@dataclasses.dataclass
class DSEResult:
    plan: ExecutionPlan
    schedule: Schedule
    problem: ScheduleProblem
    solver: str
    stage1_s: float
    stage2_s: float
    makespan: float
    optimal: bool


def _plan_from_schedule(workload: MMWorkload, problem: ScheduleProblem,
                        schedule: Schedule) -> ExecutionPlan:
    planned = []
    for p in sorted(schedule.placements, key=lambda q: (q.start, q.layer)):
        layer = workload.layers[p.layer]
        mode = problem.modes[p.layer][p.mode_idx]
        tile = tuple(mode.meta) if mode.meta else (layer.m, layer.k, layer.n)
        planned.append(PlannedLayer(
            layer=p.layer, name=layer.name, mkn=(layer.m, layer.k, layer.n),
            mode_fmus=mode.fmus, mode_cus=mode.cus, tile=tile,
            start=p.start, end=p.end, fmu_ids=p.fmu_ids, cu_ids=p.cu_ids))
    return ExecutionPlan(workload.name, tuple(planned), schedule.makespan)


def run_dse(workload: MMWorkload, accel: AccelConfig,
            platform: PlatformProfile = VCK190, *,
            f_max: Optional[int] = None, c_max: Optional[int] = None,
            solver: str = "auto", max_modes: int = 16,
            exact_time_limit_s: float = 60.0,
            ga_config: Optional[GAConfig] = None) -> DSEResult:
    f_max = f_max if f_max is not None else accel.num_fmus
    c_max = c_max if c_max is not None else accel.num_cus

    t0 = time.monotonic()
    problem = modes_lib.build_problem(workload, accel, platform,
                                      f_max=f_max, c_max=c_max,
                                      max_modes=max_modes)
    stage1_s = time.monotonic() - t0

    if solver == "auto":
        big = (problem.num_layers > AUTO_EXACT_MAX_NODES or
               max(len(m) for m in problem.modes) > AUTO_EXACT_MAX_MODES)
        solver = "ga" if big else "milp"

    t1 = time.monotonic()
    if solver == "milp":
        ga_seed = solve_ga(problem, ga_config or GAConfig(generations=40))
        res: MILPResult = solve_exact(problem,
                                      time_limit_s=exact_time_limit_s,
                                      incumbent=ga_seed.schedule)
        schedule, optimal = res.schedule, res.optimal
    elif solver == "ga":
        ga = solve_ga(problem, ga_config or GAConfig())
        schedule, optimal = ga.schedule, False
    else:
        raise ValueError(solver)
    stage2_s = time.monotonic() - t1

    assert schedule is not None
    validate(problem, schedule)
    plan = _plan_from_schedule(workload, problem, schedule)
    return DSEResult(plan=plan, schedule=schedule, problem=problem,
                     solver=solver, stage1_s=stage1_s, stage2_s=stage2_s,
                     makespan=schedule.makespan, optimal=optimal)
