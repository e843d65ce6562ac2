"""Shared engine plumbing of the port (``repro.workloads.base`` on one
device): the workload classes and the class an architecture defaults to,
the ``Engine`` protocol the fabric programs against, the bucket ladders
the serving DSE prices encode phases on, the decayed estimate of
submitted lengths behind ``recent_lengths()``, per-engine build
counting, bounded retention of finished requests, ``build_engine`` and
the runtime sanitizer (``REPRO_SANITIZE=1``)."""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dse import DesignPoint

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


def length_buckets(buckets: Sequence[int], cap: int) -> Tuple[int, ...]:
    """Normalized ascending ladder of padded-length program buckets.

    ``buckets`` are the requested sequence-length breakpoints (e.g.
    ``(128, 512)``); ``cap`` is the engine's hard capacity and is always the
    final bucket.  Entries outside ``(0, cap)`` are dropped.  A job of
    length L runs in the smallest bucket >= L, so short jobs skip the padded
    FLOPs of the full-capacity program; an empty ``buckets`` means one
    program at ``cap``.
    """
    ladder = sorted({int(b) for b in buckets if 0 < int(b) < cap})
    return tuple(ladder) + (cap,)


def pick_bucket(ladder: Sequence[int], length: int) -> int:
    """Smallest bucket in ``ladder`` that fits ``length`` (ladder is
    ascending and its last entry is the capacity, so callers reject
    oversized jobs before picking)."""
    for b in ladder:
        if length <= b:
            return b
    return ladder[-1]


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


@runtime_checkable
class Engine(Protocol):
    """What the fabric requires of a tenant engine: submit work, advance
    one batched step, expose the load signals the recomposition policy
    decides on, retune live, move onto another sub-accelerator
    (``reshard_to``: a mesh grant's ranks, sharded under the engine's
    rules) and build ahead for a candidate design point."""

    workload_class: str

    # -- work ingestion / progress --------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16) -> int: ...
    def step(self) -> List[Tuple[int, Any]]: ...
    def results(self) -> Dict[int, Any]: ...
    def snapshot(self) -> Dict[int, Any]: ...

    # -- load signals (recomposition policy inputs) ---------------------
    @property
    def queue_depth(self) -> int: ...
    @property
    def active_count(self) -> int: ...
    @property
    def has_work(self) -> bool: ...
    def pending_tokens(self) -> int: ...
    def arena_utilization(self) -> float: ...

    # -- preemption ------------------------------------------------------
    def preempt_one(self) -> Optional[int]: ...
    @property
    def preempted_depth(self) -> int: ...
    def queue_head_wait_s(self, now: Optional[float] = None) -> float: ...

    # -- design-point reconfiguration ------------------------------------
    def apply(self, sub=None,
              point: Optional[DesignPoint] = None) -> Dict[str, Any]: ...
    def warm_compile(self, sub,
                     point: Optional[DesignPoint] = None) -> int: ...
    def reshard_to(self, sub) -> None: ...
    def sync(self) -> None: ...

    # -- serving-DSE inputs/outputs -------------------------------------
    def design(self) -> Dict[str, Any]: ...
    def recent_lengths(self) -> Tuple[int, ...]: ...

    # -- telemetry --------------------------------------------------------
    reshard_count: int

    @property
    def compile_builds(self) -> int: ...
    def stats(self) -> Dict[str, Any]: ...


class EngineTelemetry:
    """Per-engine build counting against the executable cache and bounded
    finished-request retention.  Expects ``self._own_builds``,
    ``self._finished`` and ``self.finished_cap`` set by the constructor."""

    # builds bump from both a warming thread and the serving loop
    _builds_lock = threading.Lock()

    @property
    def compile_builds(self) -> int:
        """Cold builds (graph captures or eager closures) this engine
        performed."""
        return self._own_builds

    def _counted(self, builder):
        """Wrap a cold-build closure: count it for this engine and time it
        into the ``compile_build_s`` histogram and span."""
        obs = getattr(self, "_obs", None)

        def run():
            with self._builds_lock:
                self._own_builds += 1
            if obs is None or not obs.enabled:
                return builder()
            with obs.timed("compile_build", "compile_build_s"):
                result = builder()
            obs.inc("compile_builds")
            return result
        return run

    def _evict_finished(self) -> None:
        """Oldest finished records drop first; a request's slot and arena
        reservation are released at its finish site, never here."""
        while len(self._finished) > self.finished_cap:
            self._finished.pop(next(iter(self._finished)))


def build_engine(wclass: str, model, params, serve_cfg, *, exec_cache=None,
                 obs=None, mesh=None, rules=None):
    """Construct the engine serving ``wclass`` traffic for ``model`` (on
    ``mesh`` under ``rules``, where given)."""
    from repro_torch.workloads.decode import DecodeEngine
    from repro_torch.workloads.encdec import EncDecEngine
    from repro_torch.workloads.encoder import EncoderEngine
    from repro_torch.workloads.ssm import SSMEngine

    classes = {DECODE: DecodeEngine, SSM: SSMEngine, ENCODER: EncoderEngine,
               ENCDEC: EncDecEngine}
    if wclass not in classes:
        raise KeyError(f"unknown workload class {wclass!r}; known: "
                       f"{tuple(classes)}")
    return classes[wclass](model, params, serve_cfg, exec_cache=exec_cache,
                           obs=obs, mesh=mesh, rules=rules)


# ----------------------------------------------------------------------
# runtime sanitizer (REPRO_SANITIZE=1), the dynamic side of fabriclint:
#
# * sanitize_guard() forbids implicit device->host reads for an engine
#   step's decode dispatch.  On the card it arms
#   torch.cuda.set_sync_debug_mode("error"), so a synchronizing call
#   (``.item()``, ``.cpu()``, ``bool(t)``) raises; on the CPU, where
#   nothing synchronizes, a Python backstop makes ``Tensor.item``,
#   ``__int__``, ``__float__`` and ``__bool__`` raise.  The engine's
#   deliberate reads go through explicit_read(), which the guard lets
#   through (it disarms the card's mode around them): the harvest of a
#   step and a preempted slot's export inside the dispatch; the first
#   token of a prefill, outside it.
# * sanitize_check() sweeps the slot and arena bookkeeping after a step.
#
# Both are no-ops unless REPRO_SANITIZE is set, and change no numerics.
# ----------------------------------------------------------------------

SANITIZE_ENV = "REPRO_SANITIZE"


def sanitize_enabled() -> bool:
    """True when the runtime sanitizer is armed; read per call."""
    return os.environ.get(SANITIZE_ENV, "0").lower() not in ("0", "", "false")


class ImplicitTransferError(RuntimeError):
    """An implicit device->host read happened on a sanitized engine step."""


_tl = threading.local()


def _allow_depth() -> int:
    return getattr(_tl, "explicit_depth", 0)


def _card_armed() -> bool:
    return getattr(_tl, "card_armed", False)


@contextlib.contextmanager
def explicit_read():
    """A deliberate device->host read inside a sanitized step."""
    _tl.explicit_depth = _allow_depth() + 1
    card = _card_armed()
    if card:
        import torch
        torch.cuda.set_sync_debug_mode("default")
    try:
        yield
    finally:
        _tl.explicit_depth -= 1
        if card:
            import torch
            torch.cuda.set_sync_debug_mode("error")


_COERCIONS = ("item", "__int__", "__float__", "__bool__")
_patch_lock = threading.Lock()
_patch_depth = 0
_saved: Dict[str, Any] = {}


def _blocked(kind, orig):
    @functools.wraps(orig)
    def run(self, *args, **kwargs):
        if _allow_depth():
            return orig(self, *args, **kwargs)
        raise ImplicitTransferError(
            f"implicit device->host read ({kind}) on a sanitized engine "
            "step: read back through explicit_read() at a designed sync "
            "point")
    return run


@contextlib.contextmanager
def _python_transfer_guard():
    """The CPU backstop: patch the coercions of ``torch.Tensor`` to raise
    outside explicit_read().  Re-entrant: installed at depth 1, restored
    at depth 0."""
    global _patch_depth
    import torch
    with _patch_lock:
        _patch_depth += 1
        if _patch_depth == 1:
            for kind in _COERCIONS:
                orig = getattr(torch.Tensor, kind)
                _saved[kind] = orig
                setattr(torch.Tensor, kind, _blocked(kind, orig))
    try:
        yield
    finally:
        with _patch_lock:
            _patch_depth -= 1
            if _patch_depth == 0:
                for kind in _COERCIONS:
                    setattr(torch.Tensor, kind, _saved.pop(kind))


@contextlib.contextmanager
def _card_guard():
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    _tl.card_armed = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        _tl.card_armed = False
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def sanitize_guard(device=None):
    """Forbid implicit device->host reads for the enclosed engine step on
    ``device`` (a ``torch.device``; None is the CPU).  No-op when the
    sanitizer is off."""
    if not sanitize_enabled():
        yield
        return
    guard = (_card_guard if device is not None and device.type == "cuda"
             else _python_transfer_guard)
    with guard():
        yield


def sanitize_check(engine) -> None:
    """Post-step invariant sweep (no-op when the sanitizer is off): the
    arena's own check, and slot accounting that only holds when every
    release went through ``_release_slot``."""
    if not sanitize_enabled():
        return
    check = getattr(getattr(engine, "arena", None), "check", None)
    if callable(check):
        check()
    if not hasattr(engine, "_active"):
        return                  # no slots: jobs finish within their step
    active, free = engine._active, engine._free_slots
    name = type(engine).__name__
    dup = set(active) & set(free)
    if dup:
        raise AssertionError(
            f"fabric sanitizer: {name} slots both active and free: "
            f"{sorted(dup)}: a release path bypassed _release_slot")
    slots = engine.cfg.max_slots
    if len(active) + len(free) != slots:
        raise AssertionError(
            f"fabric sanitizer: {name} slot accounting diverged: "
            f"{len(active)} active + {len(free)} free != {slots} slots; "
            "some release path bypassed _release_slot")
    for slot, req in active.items():
        if req.slot != slot:
            raise AssertionError(
                f"fabric sanitizer: {name} active request in slot {slot} "
                f"records slot {req.slot}")
    for req, _ in engine._parked:
        if req.view is not None or req.slot != -1:
            raise AssertionError(
                f"fabric sanitizer: {name} parked request rid={req.rid} "
                "still holds a slot or arena view: preemption bypassed "
                "_release_slot")
