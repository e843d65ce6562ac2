"""Span tracer with Chrome/Perfetto trace-event JSON export (the port's
copy of ``repro.obs.tracing``).

``SpanTracer.span(...)`` is a context manager that records a complete
("ph": "X") trace event into a bounded ring buffer.  The record path is a
``perf_counter`` pair plus one deque append — cheap enough to leave on
for every decode step.  Spans taken on background threads (e.g. the
speculative-prewarm compile thread) land on their own ``tid`` row, which
is exactly what makes compile/dispatch overlap visible in the Perfetto
UI: open ``chrome://tracing`` or https://ui.perfetto.dev and load the
file written by ``dump`` / ``ComposedServer.dump_trace``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["SpanTracer", "NULL_SPAN"]


class _NullSpan:
    """Reusable no-op context manager for disabled telemetry."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class SpanTracer:
    """Bounded ring buffer of completed spans.

    Events are stored as dicts already in trace-event form; ``ts``/``dur``
    are microseconds relative to the tracer's origin.  The ring evicts the
    oldest spans first, so a long-running fabric keeps the most recent
    window of activity without growing.
    """

    def __init__(self, capacity: int = 8192, *, pid: int = 1) -> None:
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
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
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (t0 - self._origin) * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": self._pid,
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "serve", **args: Any):
        """Time a block and record it as a complete trace event.

        Yields the args dict so callers can attach results computed
        inside the block (e.g. ``recompose`` fills in ``moved``)."""
        payload: Dict[str, Any] = dict(args) if args else {}
        t0 = time.perf_counter()
        try:
            yield payload
        finally:
            self.record(name, t0, time.perf_counter(), payload or None,
                        cat=cat)

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        """Events sorted by start time (ring order is completion order;
        Perfetto wants nesting parents to precede children)."""
        return sorted(self._events, key=lambda e: (e["tid"], e["ts"]))

    def to_json(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path

    def clear(self) -> None:
        self._events.clear()

