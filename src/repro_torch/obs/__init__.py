"""Telemetry handle of the port (the surface of ``repro.obs.Telemetry``
the decode engine calls): a metrics registry, a span tracer, bound labels
and an ``enabled`` flag.  When disabled, every call is a constant-time
no-op, so token streams are the same with telemetry on or off.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.tracing import NULL_SPAN, SpanTracer

__all__ = ["Histogram", "MetricsRegistry", "SpanTracer", "Telemetry"]


class Telemetry:
    """Handle = (registry, tracer, bound labels, enabled flag)."""

    __slots__ = ("registry", "tracer", "labels", "enabled")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 labels: Tuple[Tuple[str, str], ...] = (),
                 enabled: bool = True) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.labels = labels
        self.enabled = enabled

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
        """Trace-only context manager (null when disabled)."""
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
        """Span + latency histogram in one context manager."""
        if not self.enabled:
            return NULL_SPAN
        return self._timed(span_name, hist_name, dict(args) if args else {})
