"""Stage-1 Runtime Parameter Optimizer (paper §3.1).

For every layer, brute-force the runtime-configurable parameters — CU count,
FMU count (= on-chip capacity share), and the on-chip tile split — under the
FMU/CU constraints, pricing each with the analytical model.  The output is
the paper's per-layer table of candidate modes (f_ik, c_ik, e_ik) with the
optimal runtime parameters attached, which Stage 2 schedules.

Dominated modes (>= resources and >= latency of another) are pruned so the
MILP/GA search space stays tight.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.common.platform import PlatformProfile
from repro_torch.configs.paper_workloads import MMLayer, MMWorkload
from repro_torch.core.analytical import AccelConfig, layer_latency
from repro_torch.core.schedule import Mode, ScheduleProblem

MIN_FMUS = 3     # an MM layer needs at least A/B/C views live


def _tile_candidates(m: int, k: int, n: int, capacity: int
                     ) -> List[Tuple[int, int, int]]:
    """Candidate on-chip tile splits fitting A+B+C in `capacity` elements."""
    sizes = [64, 128, 256, 512, 1024]
    out = []
    for tm in sizes:
        if tm > 2 * m:
            continue
        for tk in sizes:
            if tk > 2 * k:
                continue
            for tn in sizes:
                if tn > 2 * n:
                    continue
                if tm * tk + tk * tn + tm * tn <= capacity:
                    out.append((min(tm, m), min(tk, k), min(tn, n)))
    if not out:
        out.append((min(64, m), min(64, k), min(64, n)))
    return sorted(set(out))


def enumerate_modes(layer: MMLayer, accel: AccelConfig,
                    platform: PlatformProfile, *, f_max: int, c_max: int,
                    max_modes: int = 16) -> List[Mode]:
    """Brute-force (cus, fmus, tile) for one layer; return Pareto modes."""
    cu_opts = [c for c in (1, 2, 4, 8, 16) if c <= min(accel.num_cus, c_max)]
    fmu_opts = [f for f in range(MIN_FMUS, min(accel.num_fmus, f_max) + 1)]
    cand: List[Mode] = []
    for cus in cu_opts:
        for fmus in fmu_opts:
            cap = fmus * accel.fmu_capacity
            best = None
            for tile in _tile_candidates(layer.m, layer.k, layer.n, cap):
                cfg = dataclasses.replace(accel, onchip_elems=cap,
                                          num_fmus=fmus)
                lb = layer_latency(cfg, platform, layer.m, layer.k, layer.n,
                                   num_cus=cus, tile_override=tile)
                if best is None or lb.total_s < best[0].total_s:
                    best = (lb, tile)
            assert best is not None
            cand.append(Mode(fmus=fmus, cus=cus, latency=best[0].total_s,
                             meta=best[1]))
    # Pareto prune: drop modes dominated in (fmus, cus, latency)
    cand.sort(key=lambda mo: (mo.latency, mo.fmus, mo.cus))
    kept: List[Mode] = []
    for mo in cand:
        if not any(k.fmus <= mo.fmus and k.cus <= mo.cus and
                   k.latency <= mo.latency for k in kept):
            kept.append(mo)
    return kept[:max_modes]


def build_problem(workload: MMWorkload, accel: AccelConfig,
                  platform: PlatformProfile, *, f_max: int, c_max: int,
                  max_modes: int = 16) -> ScheduleProblem:
    """Stage 1 for a whole workload DAG -> a Stage-2 scheduling problem."""
    deps = tuple(tuple(l.deps) for l in workload.layers)
    modes = tuple(
        tuple(enumerate_modes(l, accel, platform, f_max=f_max, c_max=c_max,
                              max_modes=max_modes))
        for l in workload.layers)
    return ScheduleProblem(deps=deps, modes=modes, f_max=f_max, c_max=c_max)
