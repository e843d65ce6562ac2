"""Fault tolerance: preemption handling, straggler detection, restart
policy.  The port's copy of ``repro.train.fault`` (host-side, no JAX).

At thousand-node scale the assumptions are: (a) any step can be the last
(preemption / hardware fault), (b) slow hosts poison synchronous steps,
(c) restarts may come back with a different topology.  The mechanisms here:

  PreemptionGuard   — SIGTERM/flag-file -> graceful checkpoint-and-exit
  StragglerWatchdog — robust step-time statistics; flags steps exceeding
                      k x rolling median, counts consecutive events and
                      recommends CHECKPOINT_AND_RESHARD (a degraded
                      device is not swapped out of a running job: the job
                      checkpoints, drops the bad host and restarts)
  RestartPolicy     — bounded exponential backoff for the launcher loop

All host-side and unit-testable; the trainer wires them together and
checkpoint.restore() provides the elastic-reshard half of the story.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import statistics
import time
from typing import List, Optional

ACTION_NONE = "none"
ACTION_WARN = "warn"
ACTION_CHECKPOINT_AND_RESHARD = "checkpoint_and_reshard"


class PreemptionGuard:
    """Sets `requested` on SIGTERM (or when a sentinel file appears, for
    schedulers that cannot signal)."""

    def __init__(self, flag_file: Optional[str] = None,
                 install_signal: bool = True):
        self.requested = False
        self.flag_file = flag_file
        if install_signal:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not in main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True

    def check(self) -> bool:
        if self.flag_file and os.path.exists(self.flag_file):
            self.requested = True
        return self.requested


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    ratio: float


class StragglerWatchdog:
    """Rolling-median step-time monitor.

    threshold: duration / median ratio that flags a straggler.
    patience: consecutive flagged steps before recommending reshard
    (a single slow step is usually a retried DMA or GC; a *run* of them is a
    degraded host)."""

    def __init__(self, threshold: float = 2.0, window: int = 32,
                 patience: int = 3, warmup: int = 5):
        self.threshold = threshold
        self.window = window
        self.patience = patience
        self.warmup = warmup
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []
        self._consecutive = 0

    def observe(self, step: int, duration_s: float) -> str:
        self.durations.append(duration_s)
        if len(self.durations) > self.window:
            self.durations.pop(0)
        if len(self.durations) < self.warmup:
            return ACTION_NONE
        med = statistics.median(self.durations)
        ratio = duration_s / max(med, 1e-9)
        if ratio > self.threshold:
            self._consecutive += 1
            self.events.append(StragglerEvent(step, duration_s, med, ratio))
            if self._consecutive >= self.patience:
                return ACTION_CHECKPOINT_AND_RESHARD
            return ACTION_WARN
        self._consecutive = 0
        return ACTION_NONE


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    base_backoff_s: float = 5.0
    max_backoff_s: float = 300.0
    restarts: int = 0

    def next_backoff(self) -> Optional[float]:
        if self.restarts >= self.max_restarts:
            return None
        b = min(self.base_backoff_s * (2 ** self.restarts), self.max_backoff_s)
        self.restarts += 1
        return b
