"""Genetic-algorithm scheduler (paper §3.3, Fig. 7).

Chromosome = 2N genes: Encode[N] reals in [0,1] (scheduling priorities) and
Candidate[N] ints in [0, #Can-1] (mode selection).  Decoding is dependency-
aware: repeatedly append, among dependency-resolved layers, the one with the
*smallest* Encode value to the Schedule Order List (Fig. 7c), then run the
resource-constrained list scheduler along that order (Fig. 7d); fitness is
the makespan.  Crossover/mutation use the paper's random-selection strategy;
elitism keeps the best chromosome across generations.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.schedule import (Schedule, ScheduleProblem, fast_makespan,
                                 list_schedule)


@dataclasses.dataclass
class GAConfig:
    population: int = 48
    generations: int = 200
    crossover_rate: float = 0.9
    mutation_rate: float = 0.08
    tournament: int = 3
    seed: int = 0
    time_limit_s: float = float("inf")
    patience: int = 50            # stop after this many stale generations


@dataclasses.dataclass
class GAResult:
    schedule: Schedule
    makespan: float
    generations_run: int
    history: List[float]
    wall_s: float


def decode_order(problem: ScheduleProblem, encode: np.ndarray) -> List[int]:
    """Dependency-aware decoding (paper Fig. 7(c))."""
    n = problem.num_layers
    indeg = [len(d) for d in problem.deps]
    succ = problem.successors()
    resolved = {i for i in range(n) if indeg[i] == 0}
    order: List[int] = []
    while resolved:
        nxt = min(resolved, key=lambda i: (encode[i], i))
        resolved.remove(nxt)
        order.append(nxt)
        for j in succ[nxt]:
            indeg[j] -= 1
            if indeg[j] == 0:
                resolved.add(j)
    assert len(order) == n
    return order


def _fitness(problem: ScheduleProblem, encode: np.ndarray,
             cand: np.ndarray) -> Tuple[float, Tuple[List[int], List[int]]]:
    """Fitness = count-based makespan (exact, see fast_makespan); the
    decoded (order, modes) is kept so the winner can be rebuilt with unit
    ids at the end."""
    order = decode_order(problem, encode)
    mc = cand.tolist()
    return fast_makespan(problem, order, mc), (order, mc)


def solve_ga(problem: ScheduleProblem, config: Optional[GAConfig] = None
             ) -> GAResult:
    cfg = config or GAConfig()
    rng = np.random.default_rng(cfg.seed)
    n = problem.num_layers
    ncand = np.asarray([len(m) for m in problem.modes])

    pop_e = rng.random((cfg.population, n))
    pop_c = (rng.random((cfg.population, n)) * ncand).astype(np.int64)
    fits = np.empty(cfg.population)
    scheds: List[Tuple[List[int], List[int]]] = [None] * cfg.population  # type: ignore
    for p in range(cfg.population):
        fits[p], scheds[p] = _fitness(problem, pop_e[p], pop_c[p])

    best_i = int(np.argmin(fits))
    best_fit, best_sched = float(fits[best_i]), scheds[best_i]
    history = [best_fit]
    t0 = time.monotonic()
    stale = 0
    gen = 0
    for gen in range(1, cfg.generations + 1):
        if time.monotonic() - t0 > cfg.time_limit_s or stale >= cfg.patience:
            break
        new_e = np.empty_like(pop_e)
        new_c = np.empty_like(pop_c)
        for p in range(cfg.population):
            # tournament parent selection
            ia = rng.integers(cfg.population, size=cfg.tournament)
            ib = rng.integers(cfg.population, size=cfg.tournament)
            pa = ia[np.argmin(fits[ia])]
            pb = ib[np.argmin(fits[ib])]
            e, c = pop_e[pa].copy(), pop_c[pa].copy()
            if rng.random() < cfg.crossover_rate:
                mask = rng.random(n) < 0.5       # uniform random selection
                e[mask] = pop_e[pb][mask]
                c[mask] = pop_c[pb][mask]
            mut = rng.random(n) < cfg.mutation_rate
            e[mut] = rng.random(int(mut.sum()))
            mutc = rng.random(n) < cfg.mutation_rate
            c[mutc] = (rng.random(int(mutc.sum())) * ncand[mutc]).astype(np.int64)
            new_e[p], new_c[p] = e, c
        # elitism: keep the best chromosome
        new_e[0], new_c[0] = pop_e[best_i % cfg.population], pop_c[best_i % cfg.population]
        pop_e, pop_c = new_e, new_c
        improved = False
        for p in range(cfg.population):
            fits[p], scheds[p] = _fitness(problem, pop_e[p], pop_c[p])
            if fits[p] < best_fit - 1e-12:
                best_fit, best_sched = float(fits[p]), scheds[p]
                best_i = p
                improved = True
        stale = 0 if improved else stale + 1
        history.append(best_fit)
    order, mc = best_sched
    # rebuild the winner with explicit unit ids; its (unit-based) makespan is
    # authoritative — float boundary cases can differ from the count-based
    # fitness by an event's epsilon, never structurally.
    final = list_schedule(problem, order, mc)
    return GAResult(final, final.makespan, gen, history,
                    time.monotonic() - t0)
