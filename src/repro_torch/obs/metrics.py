"""Counters, gauges and latency summaries (the port's copy of the parts of
``repro.obs.metrics`` the decode engine records into).

The reference's histograms also keep a fixed log-bucket layout for
quantiles and replica merges; those readers belong to the fabric slice of
the port, so the copy keeps the exact count, sum, min and max.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


class Histogram:
    """Exact count, sum, min and max of observed values (seconds)."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class MetricsRegistry:
    """Named, labelled metrics, created on first use."""

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, LabelSet], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelSet], Gauge] = {}
        self._hists: Dict[Tuple[str, LabelSet], Histogram] = {}

    def counter_at(self, name: str, labels: LabelSet = ()) -> Counter:
        return self._counters.setdefault((name, labels), Counter())

    def gauge_at(self, name: str, labels: LabelSet = ()) -> Gauge:
        return self._gauges.setdefault((name, labels), Gauge())

    def histogram_at(self, name: str, labels: LabelSet = ()) -> Histogram:
        return self._hists.setdefault((name, labels), Histogram())
