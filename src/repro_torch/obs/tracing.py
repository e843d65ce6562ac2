"""Span tracer (the port's copy of ``repro.obs.tracing``): a bounded ring
of complete ("X") trace events in the Chrome/Perfetto format, microseconds
relative to the tracer's origin, one row per thread."""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Reusable no-op context manager for disabled telemetry."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class SpanTracer:
    """Bounded ring buffer of completed spans."""

    def __init__(self, capacity: int = 8192, *, pid: int = 1) -> None:
        self._events: deque = deque(maxlen=int(capacity))
        self._origin = time.perf_counter()
        self._pid = pid
        self._tids: Dict[int, int] = {}
        self._tid_lock = threading.Lock()

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def record(self, name: str, t0: float, t1: float,
               args: Optional[Dict[str, Any]] = None,
               cat: str = "serve") -> None:
        """Record a completed span given perf_counter() endpoints."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0 - self._origin) * 1e6,
              "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "serve", **args: Any):
        payload: Dict[str, Any] = dict(args) if args else {}
        t0 = time.perf_counter()
        try:
            yield payload
        finally:
            self.record(name, t0, time.perf_counter(), payload or None,
                        cat=cat)

    def events(self) -> List[Dict[str, Any]]:
        return sorted(self._events, key=lambda e: (e["tid"], e["ts"]))
