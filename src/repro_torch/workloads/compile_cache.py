"""Executable cache of the port (``repro.workloads.compile_cache``): built
decode and prefill steps, keyed like the reference's AOT executables.

On one H100 the counterpart of an ahead-of-time XLA executable is a
captured CUDA graph.  A decode entry on the card is a :class:`GraphStep`:
the ``torch.cuda.CUDAGraph`` of one decode step, its static output, and
the kernel launches the capture recorded.  On the CPU, and for prefill,
an entry is the eager closure of the step, under the same key, so the
build counts are the reference's.

A graph reads and writes fixed addresses: one engine's cache pool and
static inputs.  So a decode key carries the pool's generation (unique in
the process) and entries are never shared between
engines or pools; a resize evicts the old pool's entries
(:meth:`ExecutableCache.evict`), and an evicted graph is dropped with
its references.

Thread-safe: a fabric may warm a candidate composition from a
background thread while the serving loop goes on.  Builds run outside the
cache's lock; a lost race costs one duplicate build, never a wrong entry.
The engine orders a capture against its own replays (``DecodeEngine``'s
device lock).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional

from repro_torch.kernels import launches


class GraphStep:
    """A captured decode step: ``graph`` writes ``out`` from the engine's
    static inputs.  A capture calls each kernel wrapper once per launch
    without launching anything, so the capture takes back the wrappers'
    counts and keeps them as ``launches``; every replay adds them again,
    as a replay launches those kernels.  ``tickets`` is the graph's own
    ragged decode ticket buffer (None without one), which nothing else
    keeps alive."""

    def __init__(self, graph, out, captured: Dict[str, int], tickets=None):
        self.graph = graph
        self.out = out
        self.launches = {k: n for k, n in captured.items() if n}
        self.tickets = tickets
        self.replays = 0

    def __call__(self):
        self.graph.replay()
        self.replays += 1
        launches.add(self.launches)
        return self.out


class ExecutableCache:
    """A small LRU of built steps (CUDA graphs or eager closures)."""

    def __init__(self, capacity: int = 32):
        self.capacity = int(capacity)
        self.builds = 0                 # cold builds performed (telemetry)
        self.hits = 0
        self._lock = threading.Lock()
        self._exe: "OrderedDict[Hashable, Any]" = OrderedDict()

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            exe = self._exe.get(key)
            if exe is not None:
                self._exe.move_to_end(key)
                self.hits += 1
            return exe

    def contains(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._exe

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        exe = self.get(key)
        if exe is not None:
            return exe
        exe = builder()                 # outside the lock: captures are slow
        self._insert(key, exe)
        return exe

    def ensure(self, key: Hashable, builder: Callable[[], Any]) -> int:
        """Warm path: build and insert iff missing.  Returns builds done
        (0 or 1)."""
        if self.contains(key):
            return 0
        self._insert(key, builder())
        return 1

    def evict(self, match: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose key ``match`` accepts (a resized pool's
        graphs, which must never replay again).  Returns the count."""
        with self._lock:
            dead = [k for k in self._exe if match(k)]
            for k in dead:
                del self._exe[k]
        return len(dead)

    def snapshot(self) -> dict:
        """Cache-wide cold builds, warm hits and occupancy."""
        with self._lock:
            return {"builds": self.builds, "hits": self.hits,
                    "size": len(self._exe), "capacity": self.capacity}

    def _insert(self, key: Hashable, exe: Any) -> None:
        with self._lock:
            if key not in self._exe:
                self.builds += 1
            self._exe[key] = exe
            self._exe.move_to_end(key)
            while len(self._exe) > self.capacity:
                self._exe.popitem(last=False)
