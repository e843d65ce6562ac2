"""Encoder engine of the port (``repro.workloads.encoder`` on one device):
prefill-only embedding jobs, the third workload class.

Encoder jobs are compute-bound full-sequence products: no decode loop, no
growing cache, no per-token host round trip.

* Jobs queue on the host; each ``step()`` takes up to ``max_slots`` of
  them and completes them.  No device state lives between steps, so
  evacuation and adoption move only the host queue.
* A step groups its jobs by each job's own smallest fitting bucket of
  ``ServeConfig.len_buckets`` (``max_len`` always included) and runs one
  batched ``Model.encode`` per group, so a short job never pays a long
  one's padded products.  The ladder is a live design knob:
  ``apply(point.buckets)`` swaps it.  ``stats()`` counts jobs per bucket.
* A job's output is the mean of ``Model.encode``'s hidden states over its
  valid positions, in fp32: a (d_model,) embedding.  Causal stacks never
  see their padding; bidirectional stacks mask each row's own key padding
  (``Model.encode(lens=...)``), so a job's embedding does not depend on
  the ladder but for the order of its sums.
* On the card the engine does all its device work on a CUDA stream of its
  own, ``stream``; the embeddings' copy to the host ends each step.  The
  encode runs eagerly, as the decode engines' prefills do.
* On a mesh (``mesh``) each rank holds its shard of the params under
  ``rules`` (normally ``serve_engine_rules()``: heads, FFN hidden dim,
  Mamba channels, experts and vocab over the model dim where the degree
  divides them), or the whole tree with ``rules=None``; the encode runs
  on the local shards, sums the row-parallel products over the model
  group, and gives every rank the whole hidden states, so the pooling is
  unchanged.  ``reshard_to`` and ``apply(point.tp)`` move only the params:
  no job holds device state between steps.  A rank outside the mesh
  encodes nothing, its ``step()`` emits empty embeddings, and
  ``results()`` returns the mesh's.

Jobs longer than ``max_len`` are rejected but recorded (an empty
embedding) and are not emitted, so they never count as throughput.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.composer import mesh_fingerprint
from repro_torch.core.dse import DesignPoint
from repro_torch.distribution import partitioning as part
from repro_torch.models.model import Model
from repro_torch.obs import Telemetry
from repro_torch.workloads.base import (ENCODER, DecayedLengthEstimator,
                                        EngineTelemetry, explicit_read,
                                        length_buckets, pick_bucket,
                                        sanitize_check, sanitize_guard)
from repro_torch.workloads.compile_cache import ExecutableCache
from repro_torch.workloads.decode import (ServeConfig, _mesh_of, _rules_fp,
                                          move_tree)


@dataclasses.dataclass
class EncodeJob:
    """One embedding job's host-side record (``embedding`` is the fp32
    mean-pooled (d_model,) vector once done; ``[]`` marks a reject)."""

    rid: int
    tokens: np.ndarray
    embedding: Optional[List[float]] = None
    done: bool = False
    # perf_counter() at submit; rides the record through an adoption
    submitted_s: float = 0.0


class EncoderEngine(EngineTelemetry):
    """Prefill-only embedding serving (the ``encoder`` workload class):
    each step batches queued jobs through bucketed ``Model.encode`` calls
    and completes them."""

    workload_class = ENCODER

    def __init__(self, model: Model, params, cfg: ServeConfig,
                 exec_cache: Optional[ExecutableCache] = None,
                 obs: Optional[Telemetry] = None, mesh=None,
                 rules: Optional[part.ShardingRules] = None):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self._obs = obs if obs is not None else Telemetry()
        self.rules = rules
        self.reshard_count = 0
        self._tp: Optional[int] = None
        self._granted = _mesh_of(mesh)
        self.mesh = part.tp_submesh(self._granted, self._tp)
        self._shard = (part.TPShard.of(self.mesh) if self.mesh is not None
                       else None)
        self._plan = (part.ShardingPlan.of(params, model.logical_specs())
                      if self.mesh is not None else None)
        # each rank keeps its shard of the whole tree it was given
        self.params = move_tree(params, self._plan, rules, self.device, None,
                                self._shard)
        self.graph_captures = 0          # encodes run eagerly
        self._exec = (exec_cache if exec_cache is not None
                      else ExecutableCache())
        self._own_builds = 0
        self._recent_lens = DecayedLengthEstimator()
        self._buckets = length_buckets(cfg.len_buckets, cfg.max_len)
        self._bucket_hits: Dict[int, int] = {b: 0 for b in self._buckets}
        self._cfg_key = self._config_key(cfg.max_slots)
        self._queue: List[EncodeJob] = []
        self._finished: Dict[int, List[float]] = {}
        self.finished_cap = 10_000
        self._next_rid = 0
        self._seqs_done = 0
        cuda = self.device.type == "cuda"
        # the serving stream; it first waits for the caller's stream, where
        # the params were made
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _config_key(self, slots: int, buckets=None) -> Tuple:
        """Executable-cache config fingerprint at a (possibly prospective)
        design point: batch size and bucket ladder shape the encodes."""
        ladder = (length_buckets(buckets, self.cfg.max_len)
                  if buckets is not None else self._buckets)
        return (self.workload_class, self.model.cfg, slots,
                self.cfg.max_len, ladder, _rules_fp(self.rules),
                self.cfg.use_kernels)

    @property
    def _member(self) -> bool:
        """False on a rank outside the engine's mesh."""
        return self._shard is None or self._shard.member

    def reshard_to(self, sub) -> None:
        """Move the params onto a new sub-accelerator's ranks (its first
        ``tp`` columns, ``apply(point.tp)``), leaf by leaf
        (``partitioning.move_leaf``): gathered on the old mesh, broadcast
        from its first rank where a new rank held none of them (with the
        finished embeddings), and sliced into each new rank's shards.  No
        job holds device state between steps, so nothing else moves.
        Every rank calls it together; without a mesh nothing moves."""
        self._granted = _mesh_of(sub)
        mesh = part.tp_submesh(self._granted, self._tp)
        if mesh_fingerprint(mesh) != mesh_fingerprint(self.mesh):
            old = self._shard
            new = part.TPShard.of(mesh) if mesh is not None else None
            if self._plan is None:
                self._plan = part.ShardingPlan.of(self.params,
                                                  self.model.logical_specs())
            with self._on_stream():
                self.params = move_tree(self.params, self._plan, self.rules,
                                        self.device, old, new)
            if part.needs_broadcast(old, new):
                import torch.distributed as dist

                box = [self._finished]
                dist.broadcast_object_list(box, src=old.root,
                                           group=part.thread_group())
                self._finished = box[0]
            self.mesh, self._shard = mesh, new
        self.reshard_count += 1

    def sync(self) -> None:
        """Block until the serving stream's work is done."""
        if self.stream is not None:
            self.stream.synchronize()

    # ------------------------------------------------------------------
    # live design-point reconfiguration (serving DSE Stage 1's knobs)
    # ------------------------------------------------------------------
    def design(self) -> Dict[str, Any]:
        """The applied design point: TP degree over the grant (None: all
        of it), jobs per step and the bucket ladder."""
        return {"tp": self._tp, "slots": self.cfg.max_slots,
                "buckets": self._buckets}

    def apply(self, sub=None,
              point: Optional[DesignPoint] = None) -> Dict[str, Any]:
        """Apply a design-point delta live.  Encoder jobs hold no device
        state between steps, so every knob is a host-side swap: ``slots``
        the jobs per step, ``buckets`` the padded-length ladder.  ``dp``
        belongs to a replica group; ``sub`` (a grant with a mesh) and
        ``tp`` move the params (``reshard_to``).  Returns the knobs
        applied."""
        point = point if point is not None else DesignPoint(cus=0)
        applied: Dict[str, Any] = {}
        if point.tp is not None and point.tp != (self._tp or 0):
            self._tp = max(int(point.tp), 1)
            applied["tp"] = self._tp
        if _mesh_of(sub) is not None or (
                "tp" in applied and self._granted is not None):
            self.reshard_to(sub if sub is not None else self._granted)
        if point.slots is not None and int(point.slots) != self.cfg.max_slots:
            self.cfg = dataclasses.replace(self.cfg,
                                           max_slots=max(int(point.slots), 1))
            applied["slots"] = self.cfg.max_slots
        if point.buckets is not None:
            ladder = length_buckets(point.buckets, self.cfg.max_len)
            if ladder != self._buckets:
                self._buckets = ladder
                self._bucket_hits = {b: self._bucket_hits.get(b, 0)
                                     for b in ladder}
                applied["buckets"] = ladder
        if applied:
            self._cfg_key = self._config_key(self.cfg.max_slots)
        return applied

    # ------------------------------------------------------------------
    # cross-replica migration: only the host queue moves
    # ------------------------------------------------------------------
    def evacuate(self) -> Tuple[List, List[EncodeJob]]:
        """Strip this engine of its queued jobs for sibling replicas; the
        live list is always empty.  Finished records stay readable."""
        queued, self._queue = self._queue, []
        return [], queued

    def adopt_queued(self, job: EncodeJob) -> int:
        """Adopt a queued job from a sibling replica under a fresh rid."""
        rid = self._next_rid
        self._next_rid += 1
        job.rid = rid
        self._queue.append(job)
        return rid

    def export_queued(self) -> List[EncodeJob]:
        """Hand back the queued jobs (a dp grow rebalances them)."""
        queued, self._queue = self._queue, []
        return queued

    def recent_lengths(self) -> Tuple[int, ...]:
        """Recently submitted job lengths, decayed toward the newest: what
        Stage 1's ladder search prices."""
        return self._recent_lens.lengths()

    # ------------------------------------------------------------------
    # executable-cache entries: one batched encode per bucket (eager)
    # ------------------------------------------------------------------
    def _encode_fn(self, tokens, lens):
        """(B, S) right-padded tokens + (B,) valid lengths -> (B, d) fp32
        embeddings, each the mean over its valid positions.  ``lens`` also
        masks a bidirectional stack's key padding."""
        x = self.model.encode(self.params, {"tokens": tokens}, lens=lens,
                              use_kernels=self.cfg.use_kernels,
                              tp=self._shard)
        S = x.shape[1]
        mask = (torch.arange(S, device=x.device)[None, :]
                < lens[:, None]).float()
        pooled = torch.einsum("bsd,bs->bd", x.float(), mask)
        return pooled / lens.clamp(min=1).float()[:, None]

    def _build_encode(self, sb: int):
        del sb
        return self._encode_fn

    def _encode_exec(self, sb: int):
        key = ("encode", self._cfg_key + (mesh_fingerprint(self.mesh),), sb)
        return self._exec.get_or_build(
            key, self._counted(lambda: self._build_encode(sb)))

    def warm_compile(self, sub, point: Optional[DesignPoint] = None) -> int:
        """Build the encode of every bucket of the current or a candidate
        ladder: the ladder is finite, so this covers the design point (on
        ``sub``'s mesh narrowed to ``point.tp``; None: the current ones).
        Returns the builds performed."""
        point = point if point is not None else DesignPoint(cus=0)
        granted = _mesh_of(sub) if sub is not None else self._granted
        fp = mesh_fingerprint(part.tp_submesh(
            granted, point.tp if point.tp is not None else self._tp))
        with self._obs.timed("warm_compile", "warm_compile_s") as sp:
            key = self._config_key(point.slots or self.cfg.max_slots,
                                   point.buckets) + (fp,)
            ladder = (length_buckets(point.buckets, self.cfg.max_len)
                      if point.buckets is not None else self._buckets)
            built = sum(self._exec.ensure(
                ("encode", key, sb),
                self._counted(lambda sb=sb: self._build_encode(sb)))
                for sb in ladder)
            if sp is not None:
                sp["builds"] = built
        return built

    # ------------------------------------------------------------------
    # load signals
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return 0                       # jobs complete within their step

    @property
    def has_work(self) -> bool:
        return bool(self._queue)

    def pending_tokens(self) -> int:
        """Prompt tokens owed: encoder demand is full-sequence compute."""
        return sum(len(j.tokens) for j in self._queue)

    def arena_utilization(self) -> float:
        """Batch-fill pressure: how far the queue over-subscribes a step."""
        return min(1.0, len(self._queue) / max(self.cfg.max_slots, 1))

    # -- preemption: no job holds device state past its step --------------
    preempt_count = 0

    def preempt_one(self) -> Optional[int]:
        return None

    @property
    def preempted_depth(self) -> int:
        return 0

    def queue_head_wait_s(self, now: Optional[float] = None) -> float:
        """Seconds the oldest queued job has waited (0.0 if none)."""
        stamps = [j.submitted_s for j in self._queue if j.submitted_s > 0.0]
        if not stamps:
            return 0.0
        return max((now if now is not None else time.perf_counter())
                   - min(stamps), 0.0)

    def take_step_device(self) -> Optional[Tuple[float, int]]:
        """The decode engines' device timing of a step; an encode step is
        not a decode step, so nothing here."""
        return None

    def stats(self) -> Dict[str, Any]:
        """Queue depth, owed prompt tokens, batch-fill pressure, builds,
        completed sequences and jobs served per bucket."""
        return {
            "workload_class": self.workload_class,
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "pending_tokens": self.pending_tokens(),
            "arena_utilization": round(self.arena_utilization(), 4),
            "reshard_count": self.reshard_count,
            "compile_builds": self.compile_builds,
            "graph_captures": self.graph_captures,
            "seqs_done": self._seqs_done,
            "bucket_hits": {str(b): n for b, n in self._bucket_hits.items()},
            "design": self.design(),
        }

    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 0) -> int:
        """Queue one embedding job.  ``max_new_tokens`` is the Engine
        protocol's and is ignored: nothing is generated."""
        del max_new_tokens
        rid = self._next_rid
        self._next_rid += 1
        toks = np.asarray(tokens, np.int32)
        self._recent_lens.append(len(toks))
        self._queue.append(EncodeJob(rid, toks,
                                     submitted_s=time.perf_counter()))
        self._obs.inc("requests_submitted")
        return rid

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def step(self) -> List[Tuple[int, List[float]]]:
        """One iteration: up to ``max_slots`` queued jobs through their
        buckets' encodes, completed.  Returns [(rid, embedding)]."""
        emitted: List[Tuple[int, List[float]]] = []
        batch: List[EncodeJob] = []
        while self._queue and len(batch) < self.cfg.max_slots:
            job = self._queue.pop(0)
            if len(job.tokens) > self.cfg.max_len:
                # rejected but recorded, and not emitted: emitted entries
                # are completed sequences, which the fabric counts
                job.done = True
                job.embedding = []
                self._record_finished(job)
                continue
            batch.append(job)
        if not batch:
            return emitted
        obs = self._obs
        if obs.enabled:
            now = time.perf_counter()
            for job in batch:
                if job.submitted_s > 0.0:
                    obs.observe("queue_wait_s", now - job.submitted_s)
        groups: Dict[int, List[EncodeJob]] = {}
        for job in batch:
            groups.setdefault(pick_bucket(self._buckets, len(job.tokens)),
                              []).append(job)
        B = self.cfg.max_slots
        # the encoder's step under the fleet's one step-latency metric
        with obs.timed("encode_step", "decode_step_s", jobs=len(batch)), \
                sanitize_guard(self.device), self._on_stream():
            for sb in sorted(groups):
                jobs = groups[sb]
                self._bucket_hits[sb] += len(jobs)
                toks = np.zeros((B, sb), np.int32)
                lens = np.zeros((B,), np.int32)
                for i, job in enumerate(jobs):
                    toks[i, :len(job.tokens)] = job.tokens
                    lens[i] = len(job.tokens)
                with obs.timed("encode", "encode_s", bucket=sb, n=len(jobs)):
                    exe = self._encode_exec(sb)
                    emb = [[] for _ in jobs]    # a rank outside the mesh
                    if self._member:
                        out = exe(self._to_device(toks),
                                  self._to_device(lens))
                        with explicit_read():
                            # the designed completion point: the
                            # embeddings are the step's results
                            emb = out[:len(jobs)].cpu().numpy()
                for i, job in enumerate(jobs):
                    job.embedding = [float(v) for v in emb[i]]
                    job.done = True
                    self._record_finished(job)
                    emitted.append((job.rid, job.embedding))
        sanitize_check(self)
        if obs.enabled:
            done = time.perf_counter()
            for job in batch:
                if job.submitted_s > 0.0:
                    obs.observe("ttft_s", done - job.submitted_s)
            obs.set_gauge("slot_utilization", len(batch) / max(B, 1))
            obs.inc("tokens_emitted", len(batch))
        self._seqs_done += len(batch)
        return emitted

    def _record_finished(self, job: EncodeJob) -> None:
        # a copy: callers get the job's list through step()'s pairs
        self._finished[job.rid] = list(job.embedding)
        self._evict_finished()

    def run_to_completion(self, max_steps: int = 1000
                          ) -> Dict[int, List[float]]:
        """Step until idle (or ``max_steps``); returns ``snapshot()``."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        return self.snapshot()

    def results(self) -> Dict[int, List[float]]:
        """Completed (or rejected) jobs' embeddings (copies; the mesh's,
        on every rank, which all call this together)."""
        out = {rid: list(e) for rid, e in self._finished.items()}
        if self._shard is None or not part.needs_broadcast(self._shard,
                                                           None):
            return out
        import torch.distributed as dist

        box = [out]
        dist.broadcast_object_list(box, src=self._shard.root)
        return box[0]

    def snapshot(self) -> Dict[int, List[float]]:
        out: Dict[int, List[float]] = {j.rid: [] for j in self._queue}
        out.update(self.results())
        return out
