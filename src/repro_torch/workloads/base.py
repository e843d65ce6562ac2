"""Shared engine plumbing of the port (the parts of
``repro.workloads.base`` the engines use): the workload classes and the
class an architecture defaults to, the decayed estimate of submitted
lengths behind ``recent_lengths()`` and bounded retention of finished
requests."""
from __future__ import annotations

import collections
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig

# canonical workload-class ids
DECODE = "decode"
SSM = "ssm"
ENCODER = "encoder"
ENCDEC = "encdec"
WORKLOAD_CLASSES: Tuple[str, ...] = (DECODE, SSM, ENCODER, ENCDEC)


def workload_class_of(cfg: ModelConfig) -> str:
    """Default workload class for an architecture: attention-free SSM archs
    decode from recurrent state (``ssm``), encoder-decoder archs serve full
    encode-decode jobs (``encdec``), anything else with a decode loop is
    ``decode``.  ``encoder`` is never inferred: it is a tenant's choice."""
    if cfg.ssm is not None and cfg.attention_free:
        return SSM
    if cfg.encoder_layers > 0 and cfg.cross_attention:
        return ENCDEC
    return DECODE


class DecayedLengthEstimator:
    """Exponentially decayed estimate of the submitted-length distribution.

    Every new observation decays all older ones by ``decay`` (an effective
    window of ~1/(1-decay) observations).  ``lengths()`` emits a fixed-size
    weighted resample (largest-remainder allocation of ``resolution``
    copies), newest-heavy and deterministic.
    """

    def __init__(self, decay: float = 0.97, cap: int = 256,
                 resolution: int = 64):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = decay
        self.resolution = resolution
        self._samples: "collections.deque" = collections.deque(maxlen=cap)
        self._scale = 1.0

    def observe(self, length: int) -> None:
        self._scale /= self.decay
        if self._scale > 1e9:               # keep float headroom
            factor = self._scale
            self._samples = collections.deque(
                ((ln, w / factor) for ln, w in self._samples),
                maxlen=self._samples.maxlen)
            self._scale = 1.0
        self._samples.append((int(length), self._scale))

    def append(self, length: int) -> None:
        self.observe(length)

    def lengths(self) -> Tuple[int, ...]:
        if not self._samples:
            return ()
        total = sum(w for _, w in self._samples)
        n = min(self.resolution, len(self._samples) or 1)
        quotas = [(ln, n * w / total) for ln, w in self._samples]
        counts = [(ln, int(q)) for ln, q in quotas]
        short = n - sum(c for _, c in counts)
        order = sorted(range(len(quotas)),
                       key=lambda i: (quotas[i][1] - int(quotas[i][1]), i),
                       reverse=True)
        for i in order[:short]:
            counts[i] = (counts[i][0], counts[i][1] + 1)
        out: List[int] = []
        for ln, c in counts:
            out.extend([ln] * c)
        return tuple(out)


class EngineTelemetry:
    """Bounded finished-request retention.  Expects ``self._finished`` and
    ``self.finished_cap`` set by the constructor."""

    def _evict_finished(self) -> None:
        """Oldest finished records drop first; a request's slot and arena
        reservation are released at its finish site, never here."""
        while len(self._finished) > self.finished_cap:
            self._finished.pop(next(iter(self._finished)))
