"""Counters, gauges, and log-bucketed histograms for the serving fabric
(the port's copy of ``repro.obs.metrics``).

Zero-dependency (stdlib-only) metrics primitives.  Everything here is
designed around two constraints from the serving hot path:

* **Always-on cheap.**  ``Histogram.observe`` is an integer log2 + one
  list increment; ``Counter.inc``/``Gauge.set`` are a single attribute
  update.  No locks on the record path (the fabric is single-threaded per
  engine; background compile threads only touch their own spans/counters
  through CPython-atomic ops).
* **Mergeable across replicas.**  All histograms share one fixed bucket
  layout, so merging dp replicas (or a retired replica's registry after a
  drain-and-rebalance) is element-wise addition — quantiles computed from
  a merged histogram are deterministic functions of the union of
  observations, regardless of merge order.

Bucket layout: buckets grow by ``2**(1/8)`` (8 buckets per doubling,
~9.05% relative width) starting at ``HIST_BASE`` seconds.  With 288
buckets the range covers 100 ns .. ~19 hours, wide enough for everything
from a single decode step to a cold compile, while a whole histogram is
just a 288-int list (lazily allocated).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Tuple

__all__ = [
    "HIST_BASE",
    "HIST_BUCKETS_PER_DOUBLING",
    "HIST_NBUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "bucket_bounds",
    "metric_key",
]

HIST_BASE = 1e-7                 # seconds; lower edge of bucket 0
HIST_BUCKETS_PER_DOUBLING = 8    # 2**(1/8) growth => ~9% relative error
HIST_NBUCKETS = 288              # covers HIST_BASE * 2**36 ~= 6.9e3 s

_LOG2_BASE = math.log2(HIST_BASE)


def _bucket_index(value: float) -> int:
    """Index of the log bucket containing ``value`` (clamped to range)."""
    if value <= HIST_BASE:
        return 0
    i = int((math.log2(value) - _LOG2_BASE) * HIST_BUCKETS_PER_DOUBLING)
    if i < 0:
        return 0
    if i >= HIST_NBUCKETS:
        return HIST_NBUCKETS - 1
    return i


def bucket_bounds(index: int) -> Tuple[float, float]:
    """(lower, upper) value edges of bucket ``index``."""
    lo = HIST_BASE * 2.0 ** (index / HIST_BUCKETS_PER_DOUBLING)
    hi = HIST_BASE * 2.0 ** ((index + 1) / HIST_BUCKETS_PER_DOUBLING)
    return lo, hi


class Histogram:
    """Fixed-layout log-bucketed histogram with exact count/sum/min/max.

    Quantiles are deterministic: a cumulative scan over the fixed buckets
    with linear interpolation inside the target bucket, so two histograms
    holding the same multiset of observations report identical quantiles
    (and so does their merge).
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * HIST_NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[_bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> "Histogram":
        counts = self.counts
        for i, c in enumerate(other.counts):
            if c:
                counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max
        return self

    def quantile(self, q: float) -> float:
        """Deterministic quantile estimate (seconds); nan when empty."""
        if self.count == 0:
            return math.nan
        q = min(max(q, 0.0), 1.0)
        # Rank in [1, count]; ceil keeps q=0.5 of {a,b} inside a's bucket.
        rank = min(max(int(math.ceil(q * self.count)), 1), self.count)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo, hi = bucket_bounds(i)
                frac = (rank - cum) / c
                est = lo + frac * (hi - lo)
                # Exact extremes beat bucket edges when they are tighter.
                return min(max(est, self.min), self.max)
            cum += c
        return self.max  # unreachable unless counts drifted

    def fraction_below(self, threshold: float) -> float:
        """Fraction of observations <= ``threshold`` — the SLO-attainment
        primitive (e.g. ``fraction_below(ttft_target)`` is the tenant's
        TTFT attainment).  Deterministic like :meth:`quantile`: whole
        buckets count exactly, the straddling bucket interpolates
        linearly, and the exact min/max tighten the edges so a histogram
        whose max is under the target reports exactly 1.0.  ``nan`` when
        empty."""
        if self.count == 0:
            return math.nan
        x = float(threshold)
        if x >= self.max:
            return 1.0
        if x < self.min:
            return 0.0
        below = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo, hi = bucket_bounds(i)
            if hi <= x:
                below += c
            elif lo <= x:
                below += c * (x - lo) / (hi - lo)
        return min(max(below / self.count, 0.0), 1.0)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly view: exact stats + sparse non-zero buckets."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
        }


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time level.  Merging registries keeps the max (the
    hottest replica) — use counters/histograms for additive quantities."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Mapping[str, str]) -> LabelSet:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def metric_key(name: str, labels: LabelSet) -> str:
    """Render ``name{k=v,...}`` — the snapshot/export key format."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Named, labelled metrics with merge + JSON snapshot.

    Keys are ``(name, sorted-label-tuple)``.  ``merge`` folds another
    registry in: counters add, histograms bucket-add, gauges keep max.
    A ``ReplicaGroup`` merges its per-replica registries (plus the
    registries of replicas retired by a dp shrink) into one view.
    """

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, LabelSet], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelSet], Gauge] = {}
        self._hists: Dict[Tuple[str, LabelSet], Histogram] = {}

    # -- get-or-create handles -------------------------------------------
    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _labelset(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _labelset(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        key = (name, _labelset(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        return h

    # -- label-tuple fast path (used by Telemetry, avoids kwargs dicts) --
    def counter_at(self, name: str, labels: LabelSet = ()) -> Counter:
        key = (name, labels)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge_at(self, name: str, labels: LabelSet = ()) -> Gauge:
        key = (name, labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram_at(self, name: str, labels: LabelSet = ()) -> Histogram:
        key = (name, labels)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        return h

    # -- aggregation ------------------------------------------------------
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for key, c in other._counters.items():
            self._counters.setdefault(key, Counter()).inc(c.value)
        for key, g in other._gauges.items():
            mine = self._gauges.setdefault(key, Gauge())
            if g.value > mine.value:
                mine.value = g.value
        for key, h in other._hists.items():
            self._hists.setdefault(key, Histogram()).merge(h)
        return self

    @staticmethod
    def merged(registries: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
        out = MetricsRegistry()
        for r in registries:
            out.merge(r)
        return out

    def merged_histogram(self, name: str,
                         **match: str) -> Histogram:
        """Merge all histograms named ``name`` whose labels include
        ``match`` (e.g. all replicas/classes of one tenant)."""
        want = set(_labelset(match))
        out = Histogram()
        for (n, labels), h in self._hists.items():
            if n == name and want.issubset(labels):
                out.merge(h)
        return out

    def find_histograms(self, name: str) -> Dict[str, Histogram]:
        return {metric_key(n, ls): h
                for (n, ls), h in self._hists.items() if n == name}

    # -- export -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, object]]:
        return {
            "counters": {metric_key(n, ls): c.value
                         for (n, ls), c in sorted(self._counters.items())},
            "gauges": {metric_key(n, ls): g.value
                       for (n, ls), g in sorted(self._gauges.items())},
            "histograms": {metric_key(n, ls): h.snapshot()
                           for (n, ls), h in sorted(self._hists.items())},
        }
