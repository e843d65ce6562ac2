"""Fabric-wide telemetry of the port (the port's copy of ``repro.obs``):
metrics registry, span tracer, prediction ledger.

The one object threaded through the serving stack is :class:`Telemetry` —
a thin handle bundling a :class:`MetricsRegistry`, a :class:`SpanTracer`,
a pre-bound label set, and an ``enabled`` flag.  Engines call
``obs.observe(...)`` / ``obs.span(...)`` unconditionally; when telemetry
is disabled every call is a constant-time no-op (and ``span`` returns a
shared null context manager), so token streams are bit-identical with
telemetry on or off.

Scoping rules:

* ``scoped(**labels)`` shares the registry and tracer but appends labels
  (e.g. the fabric hands each tenant's group ``scoped(tenant=..,
  wclass=..)``).
* ``fresh()`` keeps labels and tracer but allocates a *new* registry —
  used per dp replica so :class:`~repro_torch.serve.fabric.ReplicaGroup` can
  merge replica histograms (and harvest a retired replica's registry on
  a dp shrink) without double counting.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      bucket_bounds, metric_key)
from .tracing import NULL_SPAN, SpanTracer
from .accounting import PredictionLedger

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PredictionLedger",
    "SpanTracer",
    "Telemetry",
    "bucket_bounds",
    "metric_key",
]


class Telemetry:
    """Handle = (registry, tracer, bound labels, enabled flag)."""

    __slots__ = ("registry", "tracer", "labels", "enabled")

    def __init__(self,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 labels: Tuple[Tuple[str, str], ...] = (),
                 enabled: bool = True) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.labels = labels
        self.enabled = enabled

    @classmethod
    def off(cls) -> "Telemetry":
        """Disabled handle: every record call is a no-op."""
        return cls(enabled=False)

    # -- scoping ----------------------------------------------------------
    def scoped(self, **labels: str) -> "Telemetry":
        """Same registry/tracer, extra bound labels."""
        merged = tuple(sorted(dict(self.labels, **{
            k: str(v) for k, v in labels.items()}).items()))
        return Telemetry(self.registry, self.tracer, merged, self.enabled)

    def fresh(self) -> "Telemetry":
        """Same labels/tracer, new registry (one per dp replica)."""
        return Telemetry(MetricsRegistry(), self.tracer, self.labels,
                         self.enabled)

    # -- record path ------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        if self.enabled:
            self.registry.histogram_at(name, self.labels).observe(value)

    def inc(self, name: str, n=1) -> None:
        if self.enabled:
            self.registry.counter_at(name, self.labels).inc(n)

    def set_gauge(self, name: str, value: float) -> None:
        if self.enabled:
            self.registry.gauge_at(name, self.labels).value = value

    def span(self, name: str, **args: Any):
        """Trace-only context manager (null CM when disabled)."""
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name, **args)

    @contextmanager
    def _timed(self, span_name: str, hist_name: Optional[str],
               args: Dict[str, Any]):
        t0 = time.perf_counter()
        try:
            yield args
        finally:
            t1 = time.perf_counter()
            self.tracer.record(span_name, t0, t1, args or None)
            if hist_name is not None:
                self.registry.histogram_at(
                    hist_name, self.labels).observe(t1 - t0)

    def timed(self, span_name: str, hist_name: Optional[str] = None,
              **args: Any):
        """Span + latency histogram in one context manager.

        Yields the span's args dict so callers can attach fields computed
        inside the block."""
        if not self.enabled:
            return NULL_SPAN
        return self._timed(span_name, hist_name, dict(args) if args else {})
