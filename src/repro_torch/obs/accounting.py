"""Predicted-vs-measured accounting for design-point commitments.

Every time the serving policy (``AnalyticalPolicy`` / ``Stage1Optimizer``)
commits a design point, the fabric records the *predicted* per-unit step
cost (seconds per owed work unit, i.e. ``DesignPoint.cost``) against a
compact design key.  The steady-state serving loop then feeds *measured*
per-unit step times (host-side step wall time / tokens emitted, taken
around the existing pipelined-dispatch sync point — no extra device
syncs) into a histogram for the same ``(tenant, class, design key)``.

``summary()`` is the substrate the ROADMAP's online-calibration item
regresses against: per-entry predicted/measured ratios plus an aggregate
log-error, directly answering "how wrong is ``core/analytical.py`` and
in which direction", as a first-class metric instead of a benchmark
anecdote.  On one GPU a tenant's CUs are a share of the card, so the
ledger's per-design-key ratios are also where a share that leaks shows:
measured cost that does not follow the predicted one across grants.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from .metrics import Histogram

__all__ = ["PredictionLedger"]


class _Entry:
    __slots__ = ("wclass", "predicted", "commits", "hist")

    def __init__(self, wclass: str = "") -> None:
        self.wclass = wclass
        self.predicted: Optional[float] = None
        self.commits = 0
        self.hist = Histogram()


class PredictionLedger:
    """Maps (tenant, design key) -> predicted unit cost + measured hist."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, str], _Entry] = {}

    def commit(self, tenant: str, wclass: str, key: str,
               predicted_unit_s: float) -> None:
        """Record that the policy committed ``key`` for ``tenant`` with a
        predicted per-unit step cost (seconds per token / work unit)."""
        if not (math.isfinite(predicted_unit_s) and predicted_unit_s > 0):
            return
        e = self._entries.setdefault((tenant, key), _Entry(wclass))
        e.wclass = wclass or e.wclass
        e.predicted = float(predicted_unit_s)
        e.commits += 1

    def observe(self, tenant: str, key: str, measured_unit_s: float,
                wclass: str = "") -> None:
        """Feed one measured per-unit step time for the active design."""
        e = self._entries.setdefault((tenant, key), _Entry(wclass))
        e.hist.observe(measured_unit_s)

    def __len__(self) -> int:
        return len(self._entries)

    def summary(self) -> Dict[str, object]:
        """Per-(tenant, class, design key) predicted/measured ratios.

        ``ratio`` > 1 means the analytical model over-predicts cost.  The
        aggregate reports the mean |log2 ratio| (symmetric in over/under
        prediction) over entries that have both sides.
        """
        entries = {}
        log_errs = []
        for (tenant, key), e in sorted(self._entries.items()):
            measured = e.hist.quantile(0.5) if e.hist.count else None
            ratio = None
            if e.predicted is not None and measured:
                ratio = e.predicted / measured
                log_errs.append(abs(math.log2(ratio)))
            entries[f"{tenant}|{key}"] = {
                "class": e.wclass,
                "design": key,
                "predicted_unit_s": e.predicted,
                "measured_p50_unit_s": measured,
                "measured_n": e.hist.count,
                "commits": e.commits,
                "ratio": ratio,
            }
        agg: Dict[str, object] = {"entries_with_both": len(log_errs)}
        if log_errs:
            agg["mean_abs_log2_error"] = sum(log_errs) / len(log_errs)
            agg["worst_abs_log2_error"] = max(log_errs)
        return {"entries": entries, "aggregate": agg}
