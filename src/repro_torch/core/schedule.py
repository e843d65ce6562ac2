"""Scheduling problem structures shared by the MILP-equivalent exact solver
and the GA heuristic (paper §3.2–3.3).

A problem is a layer DAG with per-layer execution-mode candidates
(f_ik FMUs, c_ik CUs, e_ik latency — the Stage-1 table) plus platform
resource bounds (F_max, C_max).  A schedule picks one mode per layer
(Eq. 1), start/end times respecting dependencies (Eq. 2), and explicit
FMU/CU unit assignments such that no unit runs two overlapping layers
(Eq. 3–4) and counts match the chosen mode (Eq. 5); the objective is
makespan (Eq. 6).

``validate()`` checks a schedule against exactly that constraint set;
``list_schedule()`` is the serial schedule-generation scheme used by the GA
decoder and the exact solver's branching.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Mode:
    fmus: int                 # f_ik
    cus: int                  # c_ik
    latency: float            # e_ik
    meta: tuple = ()          # runtime parameters (tiles, views) — opaque here


@dataclasses.dataclass(frozen=True)
class ScheduleProblem:
    deps: Tuple[Tuple[int, ...], ...]      # deps[i] = predecessor layer ids
    modes: Tuple[Tuple[Mode, ...], ...]    # modes[i] = candidate modes
    f_max: int
    c_max: int

    @property
    def num_layers(self) -> int:
        return len(self.deps)

    def topo_order(self) -> List[int]:
        n = self.num_layers
        indeg = [len(d) for d in self.deps]
        succ: List[List[int]] = [[] for _ in range(n)]
        for i, ds in enumerate(self.deps):
            for d in ds:
                succ[d].append(i)
        ready = [i for i in range(n) if indeg[i] == 0]
        out = []
        while ready:
            i = ready.pop()
            out.append(i)
            for j in succ[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        assert len(out) == n, "dependency cycle"
        return out

    def successors(self) -> List[List[int]]:
        succ: List[List[int]] = [[] for _ in range(self.num_layers)]
        for i, ds in enumerate(self.deps):
            for d in ds:
                succ[d].append(i)
        return succ

    def critical_path_lb(self) -> float:
        """Longest dependency chain using each layer's fastest mode."""
        best = [min(m.latency for m in ms) for ms in self.modes]
        dist = [0.0] * self.num_layers
        for i in self.topo_order():
            base = max((dist[d] for d in self.deps[i]), default=0.0)
            dist[i] = base + best[i]
        return max(dist, default=0.0)

    def area_lb(self) -> float:
        """Resource-area bound: total CU-time / C_max (and FMU analogue)."""
        cu_area = sum(min(m.cus * m.latency for m in ms) for ms in self.modes)
        fmu_area = sum(min(m.fmus * m.latency for m in ms) for ms in self.modes)
        return max(cu_area / self.c_max, fmu_area / self.f_max)

    def lower_bound(self) -> float:
        return max(self.critical_path_lb(), self.area_lb())


@dataclasses.dataclass(frozen=True)
class Placement:
    layer: int
    mode_idx: int
    start: float
    end: float
    fmu_ids: Tuple[int, ...]
    cu_ids: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Schedule:
    placements: Tuple[Placement, ...]

    @property
    def makespan(self) -> float:
        return max((p.end for p in self.placements), default=0.0)


class InvalidSchedule(ValueError):
    pass


def validate(problem: ScheduleProblem, schedule: Schedule) -> None:
    """Raise InvalidSchedule unless every MILP constraint (Eq. 1–6) holds."""
    n = problem.num_layers
    by_layer: Dict[int, Placement] = {}
    for p in schedule.placements:
        if p.layer in by_layer:
            raise InvalidSchedule(f"layer {p.layer} scheduled twice (Eq. 1)")
        by_layer[p.layer] = p
    if len(by_layer) != n:
        raise InvalidSchedule("not all layers scheduled (Eq. 1)")
    for p in schedule.placements:
        mode = problem.modes[p.layer][p.mode_idx]
        if abs((p.end - p.start) - mode.latency) > EPS:
            raise InvalidSchedule(f"layer {p.layer}: E != S + e (Eq. 2)")
        if len(p.fmu_ids) != mode.fmus or len(p.cu_ids) != mode.cus:
            raise InvalidSchedule(f"layer {p.layer}: unit counts (Eq. 5)")
        if len(set(p.fmu_ids)) != len(p.fmu_ids) or \
           len(set(p.cu_ids)) != len(p.cu_ids):
            raise InvalidSchedule(f"layer {p.layer}: duplicate unit ids")
        if any(u >= problem.f_max for u in p.fmu_ids) or \
           any(u >= problem.c_max for u in p.cu_ids):
            raise InvalidSchedule(f"layer {p.layer}: unit id out of range")
        for d in problem.deps[p.layer]:
            if by_layer[d].end > p.start + EPS:
                raise InvalidSchedule(
                    f"dep {d}->{p.layer}: S_j < E_i (Eq. 2)")
    # Eq. 3–4: unit exclusivity among overlapping layers
    for a_i in range(len(schedule.placements)):
        for b_i in range(a_i + 1, len(schedule.placements)):
            a, b = schedule.placements[a_i], schedule.placements[b_i]
            overlap = a.start < b.end - EPS and b.start < a.end - EPS
            if not overlap:
                continue
            if set(a.fmu_ids) & set(b.fmu_ids):
                raise InvalidSchedule(
                    f"layers {a.layer},{b.layer} share an FMU while "
                    f"overlapping (Eq. 4)")
            if set(a.cu_ids) & set(b.cu_ids):
                raise InvalidSchedule(
                    f"layers {a.layer},{b.layer} share a CU while "
                    f"overlapping (Eq. 4)")


# ---------------------------------------------------------------------------
# serial schedule-generation scheme (list scheduling)
# ---------------------------------------------------------------------------

class _UnitPool:
    """Tracks per-unit busy intervals; greedy left-to-right assignment.

    Because tasks hold units for contiguous intervals and aggregate demand
    never exceeds capacity (checked by the caller's timeline), interval-graph
    perfection guarantees the greedy specific-unit assignment succeeds."""

    def __init__(self, count: int):
        self.count = count
        self.busy_until = [0.0] * count
        self.intervals: List[List[Tuple[float, float]]] = [[] for _ in range(count)]

    def free_at(self, t: float, dur: float) -> List[int]:
        out = []
        for u in range(self.count):
            if all(not (s < t + dur - EPS and t < e - EPS)
                   for s, e in self.intervals[u]):
                out.append(u)
        return out

    def take(self, units: Sequence[int], t: float, dur: float) -> None:
        for u in units:
            self.intervals[u].append((t, t + dur))


def fast_makespan(problem: ScheduleProblem, order: Sequence[int],
                  mode_choice: Sequence[int]) -> float:
    """Count-based serial SGS makespan — no unit-id assignment.

    By interval-graph perfection, aggregate-capacity feasibility equals
    specific-unit feasibility for contiguous holds, so this returns exactly
    ``list_schedule(...).makespan`` at a fraction of the cost (the GA fitness
    loop calls this thousands of times).
    """
    import numpy as np

    n = problem.num_layers
    end_time = [0.0] * n
    # events: arrays of (time, fmu_delta, cu_delta), kept time-sorted
    ev_t = [0.0]
    ev_f = [0]
    ev_c = [0]
    makespan = 0.0
    for li in order:
        mode = problem.modes[li][mode_choice[li] % len(problem.modes[li])]
        ready = max((end_time[d] for d in problem.deps[li]), default=0.0)
        dur, f, c = mode.latency, mode.fmus, mode.cus
        t_arr = np.asarray(ev_t)
        f_cum = np.cumsum(np.asarray(ev_f))
        c_cum = np.cumsum(np.asarray(ev_c))
        start = None
        # candidate starts: ready, then event times > ready
        cands = [ready] + [t for t in ev_t if t > ready + EPS]
        for t in sorted(set(cands)):
            # usage during [t, t+dur): max over events in window
            lo = np.searchsorted(t_arr, t + EPS) - 1
            hi = np.searchsorted(t_arr, t + dur - EPS, side="right")
            fmax = f_cum[lo:hi].max() if hi > lo else f_cum[lo]
            cmax = c_cum[lo:hi].max() if hi > lo else c_cum[lo]
            if fmax + f <= problem.f_max and cmax + c <= problem.c_max:
                start = t
                break
        assert start is not None
        end = start + dur
        # insert +usage at start, -usage at end
        i0 = int(np.searchsorted(t_arr, start, side="right"))
        ev_t.insert(i0, start)
        ev_f.insert(i0, f)
        ev_c.insert(i0, c)
        t_arr2 = np.asarray(ev_t)
        i1 = int(np.searchsorted(t_arr2, end, side="right"))
        ev_t.insert(i1, end)
        ev_f.insert(i1, -f)
        ev_c.insert(i1, -c)
        end_time[li] = end
        makespan = max(makespan, end)
    return makespan


def list_schedule(problem: ScheduleProblem, order: Sequence[int],
                  mode_choice: Sequence[int]) -> Schedule:
    """Schedule layers in `order` (must be dependency-compatible), each with
    its chosen mode, at the earliest resource-feasible start time."""
    n = problem.num_layers
    fmu_pool = _UnitPool(problem.f_max)
    cu_pool = _UnitPool(problem.c_max)
    end_time = [0.0] * n
    placed: List[Placement] = []
    # event times where resource availability changes
    events: List[float] = [0.0]
    for li in order:
        mode = problem.modes[li][mode_choice[li] % len(problem.modes[li])]
        ready = max((end_time[d] for d in problem.deps[li]), default=0.0)
        cands = sorted({ready} | {t for t in events if t > ready - EPS})
        start = None
        for t in cands:
            f_free = fmu_pool.free_at(t, mode.latency)
            c_free = cu_pool.free_at(t, mode.latency)
            if len(f_free) >= mode.fmus and len(c_free) >= mode.cus:
                start = t
                fmu_ids = tuple(f_free[: mode.fmus])
                cu_ids = tuple(c_free[: mode.cus])
                break
        assert start is not None, "no feasible slot found (should not happen)"
        fmu_pool.take(fmu_ids, start, mode.latency)
        cu_pool.take(cu_ids, start, mode.latency)
        end = start + mode.latency
        end_time[li] = end
        events.append(end)
        placed.append(Placement(li, mode_choice[li] % len(problem.modes[li]),
                                start, end, fmu_ids, cu_ids))
    return Schedule(tuple(placed))
