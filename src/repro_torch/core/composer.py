"""CU composer of the port (``repro.core.composer`` on one GPU): FILCO's
"composed into a unified or multiple independent accelerators" (paper §1,
§2.1) on one card.

The reference makes a CU one column of a device mesh's model axis and
composes sub-meshes.  One H100 has no mesh, so here a CU is a *logical
share* of the card: :class:`CUComposer` carves the card's ``num_cus``
CU ids into disjoint :class:`SubAccelerator` grants, each holding its CU
ids, the device and its share ``len(cu_ids) / num_cus``.  What a grant
enforces is the serving fabric's business (``repro_torch.serve.fabric``):
slot and arena budgets priced on the share, and one CUDA stream per
tenant engine.  The delta planning — ``plan_recomposition`` and
``recomposition_delta``, where unmoved tenants keep their exact CU ids —
is the reference's pure integer arithmetic, copied as it is.

``tp_submesh`` and ``replica_submesh`` (reference
``distribution/partitioning.py``) are the same tilings of a grant's CU
ids.  Framework-free: the device is carried, never touched.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.dse import ExecutionPlan, PlannedLayer


@dataclasses.dataclass(frozen=True)
class SubAccelerator:
    """A composed accelerator: a set of the card's CU ids."""

    name: str
    cu_ids: Tuple[int, ...]
    device: Any = None               # the card (None: no device attached)
    share: float = 0.0               # len(cu_ids) / the card's CU count


class CUComposer:
    """Carves ``num_cus`` logical CUs of one device into sub-accelerators
    (the counterpart of the reference's ``MeshComposer``)."""

    def __init__(self, num_cus: int, device: Any = None):
        if int(num_cus) < 1:
            raise ValueError(f"a fabric needs at least one CU, got {num_cus}")
        self.num_cus = int(num_cus)
        self.device = device

    def _sub(self, name: str, ids: Sequence[int]) -> SubAccelerator:
        ids = tuple(ids)
        return SubAccelerator(name, ids, self.device, len(ids) / self.num_cus)

    def unified(self) -> SubAccelerator:
        """The monolithic composition: all CUs as one accelerator."""
        return self._sub("unified", range(self.num_cus))

    def compose(self, sizes: Sequence[int],
                names: Optional[Sequence[str]] = None) -> List[SubAccelerator]:
        """Partition the CUs into independent accelerators of the given
        sizes (must sum to the CU count)."""
        assert sum(sizes) == self.num_cus, (sizes, self.num_cus)
        out, start = [], 0
        for i, size in enumerate(sizes):
            out.append(self._sub(names[i] if names else f"sub{i}",
                                 range(start, start + size)))
            start += size
        return out

    def submesh(self, cu_ids: Sequence[int], name: str) -> SubAccelerator:
        """A sub-accelerator over an arbitrary (possibly non-contiguous) set
        of CU ids — delta recomposition routinely produces gaps."""
        ids = tuple(sorted(cu_ids))
        if not ids or ids[0] < 0 or ids[-1] >= self.num_cus:
            raise ValueError(f"cu_ids {ids} outside fabric of {self.num_cus}")
        return self._sub(name, ids)

    def recompose(self, current: Mapping[str, SubAccelerator],
                  target_sizes: Mapping[str, int],
                  ) -> Tuple[Dict[str, SubAccelerator], "RecompositionDelta"]:
        """Delta recomposition: grow/shrink/admit/evict tenants while leaving
        every unaffected tenant's grant untouched (the same SubAccelerator
        object, hence the same CU ids).  Returns the new composition plus
        the delta describing who moved."""
        cur_ids = {t: sub.cu_ids for t, sub in current.items()}
        new_ids = plan_recomposition(cur_ids, target_sizes, self.num_cus)
        delta = recomposition_delta(cur_ids, new_ids)
        out: Dict[str, SubAccelerator] = {}
        for t, ids in new_ids.items():
            out[t] = current[t] if t in delta.unchanged else \
                self.submesh(ids, t)
        return out, delta


def tp_submesh(sub: Optional[SubAccelerator],
               degree: Optional[int]) -> Optional[SubAccelerator]:
    """The first ``degree`` CUs of a grant (the reference's tensor-parallel
    slice).  ``degree`` of None/0, or >= the grant, returns it unchanged."""
    if sub is None or not degree or degree >= len(sub.cu_ids):
        return sub
    ids = sub.cu_ids[:degree]
    return dataclasses.replace(sub, cu_ids=ids,
                               share=sub.share * len(ids) / len(sub.cu_ids))


def replica_submesh(sub: Optional[SubAccelerator], index: int,
                    replicas: int) -> Optional[SubAccelerator]:
    """Tile ``index`` of a grant cut into ``replicas`` disjoint equal-width
    tiles (a ``ReplicaGroup`` runs one engine per tile).  CUs past
    ``replicas * (width // replicas)`` are left idle when the grant does
    not divide evenly; ``replicas`` <= 1 returns the grant unchanged."""
    if sub is None or replicas <= 1:
        return sub
    n = len(sub.cu_ids)
    width = n // replicas
    if width < 1:
        raise ValueError(f"cannot tile {n} CUs into {replicas} replica "
                         "slices")
    if not 0 <= index < replicas:
        raise ValueError(f"replica index {index} out of range for "
                         f"{replicas} replicas")
    ids = sub.cu_ids[index * width:(index + 1) * width]
    return dataclasses.replace(sub, cu_ids=ids, share=sub.share * width / n)


@dataclasses.dataclass(frozen=True)
class RecompositionDelta:
    """Which tenants a recomposition touches.  ``unchanged`` tenants keep the
    exact same CU ids; only ``moved`` and ``admitted`` tenants are
    reconfigured — FILCO's real-time reconfiguration is cheap precisely
    because the delta is partial."""

    unchanged: Tuple[str, ...]
    moved: Tuple[str, ...]
    admitted: Tuple[str, ...]
    evicted: Tuple[str, ...]


def plan_recomposition(current: Mapping[str, Sequence[int]],
                       target_sizes: Mapping[str, int],
                       num_cus: int) -> Dict[str, Tuple[int, ...]]:
    """Assign CU ids for ``target_sizes`` (tenant -> CU count), minimizing
    movement relative to ``current`` (tenant -> CU ids).

    Pure integer math (no devices): tenants whose size is unchanged keep
    their exact CU set when it doesn't collide with an earlier claim; resized
    tenants prefer CUs they already own, then the lowest free ids.  Tenants
    with target size 0 (parked/evicted) get no entry.  Deterministic in the
    iteration order of ``target_sizes``.
    """
    sizes = {t: s for t, s in target_sizes.items() if s > 0}
    total = sum(sizes.values())
    if total > num_cus:
        raise ValueError(f"target sizes {dict(sizes)} need {total} CUs, "
                         f"fabric has {num_cus}")
    for t, s in sizes.items():
        old = current.get(t)
        if old is not None and any(c >= num_cus for c in old):
            raise ValueError(f"tenant {t} holds CU >= {num_cus}")

    out: Dict[str, Tuple[int, ...]] = {}
    claimed: set = set()
    # pass 1: same-size tenants keep their CUs outright
    for t, s in sizes.items():
        old = tuple(current.get(t, ()))
        if len(old) == s and not (set(old) & claimed):
            out[t] = old
            claimed |= set(old)
    # pass 2: everyone else — prefer owned CUs, then lowest free ids
    for t, s in sizes.items():
        if t in out:
            continue
        keep = [c for c in current.get(t, ()) if c not in claimed][:s]
        free = (c for c in range(num_cus)
                if c not in claimed and c not in keep)
        ids = sorted(keep + [next(free) for _ in range(s - len(keep))])
        out[t] = tuple(ids)
        claimed |= set(ids)
    return out


def recomposition_delta(current: Mapping[str, Sequence[int]],
                        new: Mapping[str, Sequence[int]]) -> RecompositionDelta:
    unchanged, moved, admitted = [], [], []
    for t, ids in new.items():
        if t not in current:
            admitted.append(t)
        elif tuple(current[t]) == tuple(ids):
            unchanged.append(t)
        else:
            moved.append(t)
    evicted = [t for t in current if t not in new]
    return RecompositionDelta(tuple(unchanged), tuple(moved),
                              tuple(admitted), tuple(evicted))


def concurrent_groups(plan: ExecutionPlan) -> List[List[PlannedLayer]]:
    """Maximal sets of layers whose schedule intervals overlap — these run
    simultaneously on disjoint compositions (validation: Eq. 4 guarantees
    disjoint CU sets)."""
    events = sorted({pl.start for pl in plan.layers})
    groups = []
    for t in events:
        live = [pl for pl in plan.layers if pl.start <= t < pl.end]
        if live and live not in groups:
            groups.append(live)
    return groups
