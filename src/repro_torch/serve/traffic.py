"""Open-loop traffic generation for the serving fabric (the port's copy of
``repro.serve.traffic``, pure numpy).

A schedule is a *pure* function of ``(profile, tenants, requests_per_tenant,
seed)``: every arrival step, prompt length and generation budget comes from
one ``numpy`` generator seeded once, so the same seed replays the identical
arrival process (pinned by tests/test_traffic.py for the reference and
tests/test_torch_fabric_policy.py for this copy) and a benchmark's paired
arms (paged vs slot-granular, preemptive vs not) see the same offered load.

Profiles (``--scenario`` in the reference's ``repro.launch.serve``):

* ``bursty`` — each tenant's requests land i.i.d. uniform over the horizon:
  overlapping per-tenant bursts that keep the fabric recomposing.
* ``diurnal`` — arrival intensity follows one raised-cosine "day" over the
  horizon (quiet at the edges, peak mid-run), sampled by inverse CDF; load
  swells and ebbs smoothly under the policy's feet.
* ``flash-crowd`` — every tenant trickles uniformly, then the *first*
  tenant's whole request budget lands inside a narrow window a third of the
  way in: queue depth spikes far past the slot pool, the regime the
  SLO-aware scheduler's preemption exists for.
* ``heavy-tail`` — uniform arrivals, but generation budgets draw from a
  Pareto tail (a few requests run many times longer than the median): the
  long-running streams accumulate pages and become the natural preemption
  victims.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["Arrival", "PROFILES", "arrival_schedule"]

PROFILES = ("bursty", "diurnal", "flash-crowd", "heavy-tail")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request arrival."""

    step: int                        # fabric step the request arrives at
    tenant: str
    prompt_len: int
    max_new: int


def _horizon(requests_per_tenant: int) -> int:
    return max(4 * requests_per_tenant, 8)


def arrival_schedule(profile: str, tenants: Sequence[str],
                     requests_per_tenant: int, seed: int, *,
                     max_new: int = 16) -> List[Arrival]:
    """The deterministic arrival schedule: ``requests_per_tenant`` arrivals
    per tenant, sorted by (step, submission order).  ``max_new`` is the
    per-request generation budget (the ``heavy-tail`` profile draws its own
    tail around it)."""
    if profile not in PROFILES:
        raise ValueError(f"unknown traffic profile {profile!r}; "
                         f"choose from {PROFILES}")
    names = list(tenants)
    R = int(requests_per_tenant)
    H = _horizon(R)
    rng = np.random.default_rng(seed)
    out: List[Arrival] = []

    def plen() -> int:
        return int(rng.integers(4, 24))

    if profile == "bursty":
        for t in names:
            for _ in range(R):
                out.append(Arrival(int(rng.integers(0, H)), t, plen(),
                                   max_new))
    elif profile == "diurnal":
        # raised-cosine intensity 1 - cos(2*pi*x) over x in [0, 1): the
        # inverse-CDF lookup turns uniform draws into one smooth "day"
        grid = np.linspace(0.0, 1.0, 513)
        cdf = grid - np.sin(2.0 * np.pi * grid) / (2.0 * np.pi)
        for t in names:
            steps = np.interp(rng.random(R), cdf, grid) * H
            for s in steps:
                out.append(Arrival(min(int(s), H - 1), t, plen(), max_new))
    elif profile == "flash-crowd":
        flash_at = H // 3
        window = max(R // 8, 1)
        for i, t in enumerate(names):
            for _ in range(R):
                step = (int(flash_at + rng.integers(0, window)) if i == 0
                        else int(rng.integers(0, H)))
                out.append(Arrival(step, t, plen(), max_new))
    else:                            # heavy-tail
        cap = 8 * max_new
        for t in names:
            for _ in range(R):
                tail = int(max_new * (1.0 + rng.pareto(1.5)))
                out.append(Arrival(int(rng.integers(0, H)), t, plen(),
                                   min(tail, cap)))
    return sorted(out, key=lambda a: a.step)
