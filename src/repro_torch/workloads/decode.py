"""Transformer decode engine of the port (``repro.workloads.decode`` on one
device): continuous batching over a pooled slot cache, FlexArena or
PagedArena admission control, bucketed prefill into a slot, pipelined
decode dispatch from an executable cache of CUDA graphs, live slot
resizing, replica evacuation and adoption, and paged preemption with
exact resume.

Decode state on the device is a pool: the model's cache (slot axis 1 on
the stacked KV tensors) and the static inputs of a decode step, all
updated in place.  A prefill writes one slot, a decode step advances
every live slot in lock-step, and slots join and leave between steps.

Executable cache: the counterpart of the reference's AOT executables.
On the card a decode step is a captured CUDA graph, keyed as the
reference keys its programs, by config and KV bound (with the pool's
generation, as a graph holds the pool's addresses); ``warm_compile``
captures ahead, and a bound never captured dispatches the smallest warm
bound that covers it.  Prefill steps are eager closures under the same
keys.  ``graphs = False`` (this module) builds eager closures on the card
too, for comparison; on the CPU every entry is one.  A graph that fails
to capture or replay raises.

Serving stream: on the card each engine does its device work on a CUDA
stream of its own, ``stream`` (a fabric's tenants then overlap on the
card): steps, captures, resizes, exports and restores, whichever thread
calls them.  A capture's side stream waits on it and it waits on the side
stream, so a ``warm_compile`` from another thread never runs its warm-up
steps ahead of a replay still queued on it.  A caller that touches the
engine's state on another stream orders it against ``stream`` itself
(``torch.cuda.synchronize()`` before and after).

Pipelined dispatch: when termination is length-based (``eos_id < 0``),
step *k* runs from the device-resident tokens of step *k-1* (the pool's
``prev``) before the host reads them; each step's tokens are copied to
pinned host memory behind an event, so the host's bookkeeping overlaps
the device's work.  The two host syncs are the reference's two
``device_get`` points: the first token of a prefill and the harvest of a
decode step.

Tensor parallelism (the reference's, over a process group: one rank per
GPU, or gloo CPU ranks).  Given a ``mesh`` (a torch ``DeviceMesh`` or a
``MeshComposer`` grant) and ``rules`` (normally ``serve_engine_rules()``),
each rank keeps its shard of the params and of the pooled cache as plain
tensors: query and KV heads (an enc-dec's cross cache with them), the
FFN hidden dim, the Mamba channels (``d_in``: the conv window and state
with them), the routed experts and the vocab split over the mesh's model
dim where the degree divides them, whole otherwise (an MLA latent cache
has no heads dim and is whole on every rank).  Its steps run the kernels
on the local heads and channels (the Mamba step in the kernel's staged
entry) and sum the row-parallel products over the model group with
explicit collectives; the greedy token is reduced from each rank's vocab
columns.  ``reshard_to`` moves params and live KV onto another sub-mesh
(another tensor-parallel degree, or the whole mesh), and
``apply(point.tp)`` narrows the grant to its first ``tp`` columns.
Without a mesh nothing moves, as the reference's ``tp_submesh(None,
...)``.  Tensor parallelism covers every arch, the enc-dec ones
included.

Every rank runs the engine's host code (admission, slots, arena), which
only the lengths and the tokens steer, so it agrees across ranks.  A rank
outside the engine's mesh does no device work and holds no tensors; with
length-based termination (``eos_id < 0``) its ``step()`` emits
placeholder tokens (-1), while ``results()`` and ``snapshot()`` return the
mesh's own (broadcast from its first rank when the mesh does not span the
world; every rank calls them together).  With an EOS id the engine
harvests every step before the next (as the reference does), and a rank
outside the mesh receives each step's tokens, and each prefill's first
token, from the mesh's first rank: every rank frees the same slots and
admits the same requests.  Preemption, evacuation and adoption move a
slot as a block of each rank's own shards of its rows
(:class:`SlotBlock`): restored onto the same mesh it is written back,
parked requests move with ``reshard_to`` as the pool does, and a block
adopted onto another rank set moves leaf by leaf as
``partitioning.move_leaf`` moves a leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import (AllocationError, FlexArena, PagedArena,
                                    ROLE_ACT)
from repro_torch.core.composer import mesh_fingerprint
from repro_torch.core.dse import DesignPoint
from repro_torch.distribution import partitioning as part
from repro_torch.kernels import launches
from repro_torch.kernels.ragged_decode import ops as ragged_ops
from repro_torch.models.model import Model
from repro_torch.obs import Telemetry
from repro_torch.workloads.base import (DECODE, DecayedLengthEstimator,
                                        EngineTelemetry, explicit_read,
                                        sanitize_check, sanitize_guard)
from repro_torch.workloads.compile_cache import ExecutableCache, GraphStep

PyTree = Any

# Decode attention reads cache[:, :kv_bound], the longest live row rounded
# up to this block, so one config has at most max_len / KV_BOUND_BLOCK
# decode graphs.
KV_BOUND_BLOCK = 32

# capture decode steps as CUDA graphs on the card; False builds eager
# closures instead (the comparison run), for engines built after the change
graphs = True
# eager steps on the capture stream before a capture: they create the
# stream's cuBLAS workspace and the kernels' per-stream buffers
_WARMUP = 2

_GENERATIONS = itertools.count()


# what a rank outside an engine's mesh records for a token it never saw
_PLACEHOLDER = -1


def move_tree(tree: PyTree, plan: Optional[part.ShardingPlan],
              rules: Optional[part.ShardingRules], device,
              old: Optional[part.TPShard],
              new: Optional[part.TPShard]) -> PyTree:
    """``tree`` (of ``plan``) from the ``old`` layout under ``rules`` to
    the ``new`` one, leaf by leaf (``partitioning.move_leaf``); nothing
    moves without a mesh on either side, and a leaf whose ranks and split
    are unchanged is kept as it is.  None on a rank outside ``new``."""
    if old is None and new is None:
        return tree
    dims_old = (plan.model_dims(rules, old.size)
                if old is not None else [None] * len(plan.shapes))
    dims_new = (plan.model_dims(rules, new.size)
                if new is not None else [None] * len(plan.shapes))
    leaves = (plan.leaves(tree) if tree is not None
              else [None] * len(plan.shapes))
    same = old is not None and new is not None and old.ranks == new.ranks
    out = []
    for t, shape, dtype, do, dn in zip(leaves, plan.shapes, plan.dtypes,
                                       dims_old, dims_new):
        if same and do == dn:
            out.append(t)
        else:
            out.append(part.move_leaf(t, shape, dtype, device, old, do, new,
                                      dn))
    if new is not None and not new.member:
        return None
    return plan.unflatten(out)


def _round_block(n: int) -> int:
    return -(-max(n, 1) // KV_BOUND_BLOCK) * KV_BOUND_BLOCK


def _mesh_of(sub):
    """A DeviceMesh, a composer grant's ``mesh`` (a one-card grant has
    none), or None."""
    if sub is None or hasattr(sub, "mesh_dim_names"):
        return sub
    return getattr(sub, "mesh", None)


def _rules_fp(rules: Optional[part.ShardingRules]):
    """Hashable identity of a rule set for executable-cache keys: the same
    config under other rules (replicated vs tensor-parallel) is another
    program."""
    if rules is None:
        return None
    return tuple(sorted(rules.rules.items()))


@dataclasses.dataclass
class SlotBlock:
    """One slot's cache rows exported by an engine on a mesh: this rank's
    shards of them on the host (None on a rank outside the mesh) and the
    layout they were cut in, ``shard`` (the exporting engine's
    ``TPShard``).  Off a mesh a block is the plain tree of host copies."""

    tree: Any
    shard: Optional[part.TPShard]


@dataclasses.dataclass
class Request:
    """One submitted request's host-side lifecycle record (``tokens`` is
    the prompt, or an enc-dec job's source: token ids or (S, d_model)
    frame embeddings)."""

    rid: int
    tokens: np.ndarray                  # prompt
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    view: Any = None                    # arena view (admission accounting)
    done: bool = False
    # tokens scheduled for emission (prefill's first token + dispatched
    # decode steps); runs ahead of len(out_tokens) by the in-flight step
    scheduled: int = 0
    # enc-dec forced decoding: target-prefix ids after BOS (None: BOS alone)
    prefix: Optional[np.ndarray] = None
    # perf_counter() at submit; rides the record through an adoption
    submitted_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Per-tenant serving dimensions."""

    max_slots: int = 4                 # concurrent decode slots
    max_len: int = 128                 # per-slot cache capacity (tokens)
    eos_id: int = 0
    prefill_bucket: int = 32           # prompts padded up to this length
    # overlap decode dispatch with host bookkeeping (when eos_id < 0)
    pipeline_decode: bool = True
    # enc-dec tenants: per-slot cross-attention source capacity in source
    # frames (0: max_len); submit()'s tokens are then the source
    max_src_len: int = 0
    # decoder start token of enc-dec jobs (the decoder prompt is [bos])
    bos_id: int = 1
    # sequence-length buckets of batched encodes (EncoderEngine jobs,
    # EncDecEngine sources); () is the capacity alone
    len_buckets: Tuple[int, ...] = ()
    # ceiling of apply()'s slot resizes, whatever the design point asks
    slot_cap: int = 64
    # hand-written kernels on the hot path: ragged decode attention over
    # the live KV prefix and flash attention in prefill, or the Mamba step
    # and selective scan
    use_kernels: bool = True
    # paged KV admission arena; kv_arena_frac scales the arena budget
    # against the dense per-slot worst case for both arena kinds
    paged_kv: bool = True
    kv_page_rows: int = 16             # rows (tokens) per page
    kv_arena_frac: float = 1.0         # arena budget / dense worst case


@dataclasses.dataclass
class _Pool:
    """The device state one set of decode graphs reads and writes: the
    pooled cache and the static inputs of a step, ``prev`` (B,) the last
    step's tokens and ``inputs`` (3, B) int32 (inject values, inject mask,
    live), on one placement: ``shard`` (the rank's ``TPShard`` on the
    pool's mesh, None without one; ``fp`` that mesh's fingerprint) and the
    ``params`` its steps read.  ``cache`` is None on a rank outside the
    mesh.  ``gen`` is unique in the process.  Its graphs share one memory
    pool, ``graph_pool`` (on the card), which goes with their eviction:
    the allocator frees a pool whose last graph is gone."""

    slots: int
    gen: int
    cache: PyTree
    axes: PyTree
    prev: torch.Tensor
    inputs: torch.Tensor
    graph_pool: Any = None
    shard: Optional[part.TPShard] = None
    fp: Optional[Tuple] = None
    params: PyTree = None

    @property
    def member(self) -> bool:
        return self.shard is None or self.shard.member


@dataclasses.dataclass
class _Inflight:
    """One dispatched decode step whose tokens the host hasn't read yet."""

    host: torch.Tensor                  # its tokens (pinned on CUDA)
    ready: Optional[torch.cuda.Event]   # set when the host copy landed
    entries: List[Tuple[int, Request, bool]]   # (slot, request, finishing)
    pipelined: bool
    # recorded on the serving stream just before the step: with ``ready``
    # it times the step on the device (None off the card)
    start: Optional[torch.cuda.Event] = None


def _tree_map(fn: Callable, axes, *trees):
    """Map ``fn(axis, *leaves)`` over cache trees shaped like ``axes``."""
    if isinstance(axes, dict):
        return {k: _tree_map(fn, a, *(t[k] for t in trees))
                for k, a in axes.items()}
    if isinstance(axes, list):
        return [_tree_map(fn, a, *(t[i] for t in trees))
                for i, a in enumerate(axes)]
    return fn(axes, *trees)


def _slot_view(cache: PyTree, axes: PyTree, slot: int) -> PyTree:
    """One slot of the pooled cache as views (slot dim kept at size 1)."""
    return _tree_map(lambda ax, t: t if ax < 0 else t.narrow(ax, slot, 1),
                     axes, cache)


def _write_slot(pool: PyTree, block: PyTree, slot: int, axes: PyTree) -> None:
    """Copy a one-slot block into slot ``slot`` of the pool, in place."""
    def write(ax, dst, src):
        if ax < 0:
            return
        view = dst.narrow(ax, slot, 1)
        if src.data_ptr() != view.data_ptr() or src.device != view.device:
            view.copy_(src)

    _tree_map(write, axes, pool, block)


def _migrate_slots(dst: PyTree, src: PyTree, src_slots: List[int],
                   axes: PyTree) -> None:
    """Copy ``src_slots``' rows of pool ``src`` into slots [0, n) of pool
    ``dst``, in place: one gather and one block write per leaf, an exact
    copy, so streams are bit-identical across a resize."""
    def cp(ax, d, s):
        if ax < 0:
            return
        idx = torch.as_tensor(src_slots, device=s.device)
        d.narrow(ax, 0, len(src_slots)).copy_(s.index_select(ax, idx))

    _tree_map(cp, axes, dst, src)


class DecodeEngine(EngineTelemetry):
    """Batched transformer decode: continuous batching over a pooled slot
    cache, arena admission control, decode steps replayed from an
    executable cache of CUDA graphs, pipelined dispatch, live slot
    resizing, replica evacuation and adoption, preemption with exact
    resume, and tensor parallelism over a mesh with live resharding.

    ``_lock`` (re-entrant) orders the host calls that launch the engine's
    device work: a step, a capture (``warm_compile`` from another thread
    included), a resize, an export or an adoption each hold it.  The
    device work itself is ordered by the engine's serving stream
    ``stream``, on which all of it runs (on the card)."""

    workload_class = DECODE

    def __init__(self, model: Model, params: PyTree, cfg: ServeConfig,
                 exec_cache: Optional[ExecutableCache] = None,
                 obs: Optional[Telemetry] = None, mesh=None,
                 rules: Optional[part.ShardingRules] = None):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self._obs = obs if obs is not None else Telemetry()
        self.rules = rules
        self.reshard_count = 0
        # tensor-parallel degree over the granted sub-mesh (None: the whole
        # grant), set per design point by apply(point.tp)
        self._tp: Optional[int] = None
        self._granted = _mesh_of(mesh)      # the last grant, unsliced
        self.mesh = part.tp_submesh(self._granted, self._tp)
        self._mesh_fp = mesh_fingerprint(self.mesh)
        self._shard = (part.TPShard.of(self.mesh) if self.mesh is not None
                       else None)
        # per-leaf (shape, dtype, logical spec) of the whole params and
        # pooled caches, fitted to any sub-mesh by the rules (on a mesh)
        self._params_plan: Optional[part.ShardingPlan] = None
        self._cache_plans: Dict[int, part.ShardingPlan] = {}
        # the memo fills from the serving loop and a warming thread
        self._plan_lock = threading.Lock()
        if self._shard is not None:
            self._params_plan = part.ShardingPlan.of(params,
                                                     model.logical_specs())
        self._recent_lens = DecayedLengthEstimator()
        self._per_token_elems = self._per_token_cache_elems()
        self.arena = self._make_arena()
        self._queue: List[Request] = []
        self._active: Dict[int, Request] = {}
        # preempted requests parked host-side with their exported cache
        self._parked: List[Tuple[Request, PyTree]] = []
        self.preempt_count = 0
        self._finished: Dict[int, List[int]] = {}
        self.finished_cap = 10_000
        self._next_rid = 0
        self._free_slots = list(range(cfg.max_slots))
        # construction commits the params to the mesh: each rank keeps its
        # shard, taken from the whole tree every rank was given
        self.params = move_tree(params, self._params_plan, self.rules,
                                self.device, None, self._shard)
        self._lock = threading.RLock()
        cuda = self.device.type == "cuda"
        # the serving stream; it first waits for the caller's stream, where
        # the params were made
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self._side = torch.cuda.Stream(self.device) if cuda else None
        with self._on_stream():
            self._pool = self._new_pool(cfg.max_slots, self._shard,
                                        self.params)
        # a candidate pool warm_compile built for another slot count
        self._staged: Optional[_Pool] = None
        self._exec = (exec_cache if exec_cache is not None
                      else ExecutableCache())
        self._own_builds = 0
        self.graph_captures = 0
        self.covering_steps = 0
        self._cfg_key = self._config_key(cfg.max_slots)
        # archs that pad to the bucket seed its length; SSM archs prefill
        # at exact lengths
        self._prefill_lens = ({self._bucketed(cfg.prefill_bucket)}
                              if model.cfg.ssm is None else set())
        self._inflight: Optional[_Inflight] = None
        # (device seconds, tokens) of the last harvested decode step on the
        # card, until a reader takes it (``take_step_device``)
        self._step_device: Optional[Tuple[float, int]] = None
        self._inject: Dict[int, int] = {}   # slot -> token since last dispatch
        self._emit_buf: List[Tuple[int, int]] = []

    def _on_stream(self):
        """The serving stream as the calling thread's current stream (a
        no-op off the card)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    @property
    def cache(self) -> PyTree:
        return self._pool.cache

    @property
    def _slot_axes(self) -> PyTree:
        return self._pool.axes

    # ------------------------------------------------------------------
    # admission accounting
    # ------------------------------------------------------------------
    def _per_token_cache_elems(self) -> int:
        """Per-token KV elements over all layers (admission accounting):
        MLA caches its latent and rope key, an attention-free arch holds
        no KV."""
        mc = self.model.cfg
        if mc.mla is not None:
            per_tok = mc.mla.kv_lora_rank + mc.mla.qk_rope_head_dim
        elif mc.attention_free:
            per_tok = 0
        else:
            per_tok = 2 * mc.num_kv_heads * mc.resolved_head_dim
        return max(per_tok, 1) * mc.num_layers

    def _arena_capacity(self) -> int:
        return self.cfg.max_slots * self.cfg.max_len * self._per_token_elems

    def _slot_rows(self, req: Request) -> int:
        return len(req.tokens) + req.max_new_tokens

    def _row_cap(self) -> int:
        return self.cfg.max_len

    def _page_rows(self) -> int:
        return max(1, min(self.cfg.kv_page_rows, self._row_cap()))

    def _arena_pages(self) -> int:
        """Page budget: the dense worst case scaled by ``kv_arena_frac``,
        floored at one slot's worth so a lone request always fits."""
        per_slot = -(-self._row_cap() // self._page_rows())
        frac = max(min(self.cfg.kv_arena_frac, 1.0), 0.0)
        want = int(round(frac * self.cfg.max_slots * per_slot))
        return max(want, per_slot, 1)

    def _make_arena(self, min_pages: int = 0):
        """Admission arena for the current config; ``min_pages`` floors
        the budget when a rebuild must re-admit live tables."""
        if not self.cfg.paged_kv:
            frac = max(min(self.cfg.kv_arena_frac, 1.0), 0.0)
            per_slot = self._row_cap() * self._per_token_elems
            floor = min_pages * self._page_rows() * self._per_token_elems
            return FlexArena(max(int(round(frac * self._arena_capacity())),
                                 per_slot, floor, 1))
        return PagedArena(max(self._arena_pages(), min_pages),
                          self._page_rows(), self._per_token_elems)

    @property
    def _paged(self) -> bool:
        return isinstance(self.arena, PagedArena)

    def _live_rows(self, req: Request) -> int:
        """Rows a paged request's table must cover for the next dispatch."""
        return min(self._dec_len(req) + 1, self._row_cap())

    def _arena_rows(self, req: Request) -> int:
        return self._live_rows(req) if self._paged else self._slot_rows(req)

    def _oversized(self, req: Request) -> bool:
        return self._slot_rows(req) > self.cfg.max_len

    def _config_key(self, slots: int) -> Tuple:
        """Executable-cache config fingerprint at a (possibly prospective)
        slot count: the model config and the serve dims that shape a
        step."""
        return (self.workload_class, self.model.cfg, slots,
                self.cfg.max_len, _rules_fp(self.rules), self.cfg.use_kernels)

    # ------------------------------------------------------------------
    # the device pool and live design-point reconfiguration
    # ------------------------------------------------------------------
    def _init_cache(self, slots: int, device=None) -> PyTree:
        """The pooled cache of ``slots`` slots (hook: enc-dec adds its
        cross cache); ``device`` "meta" gives its shapes."""
        return self.model.init_cache(slots, self.cfg.max_len, device=device)

    def _new_pool(self, slots: int, shard: Optional[part.TPShard],
                  params: PyTree) -> _Pool:
        """A zeroed pool of ``slots`` slots on ``shard``'s mesh (each rank
        its shard of the cache; none on a rank outside the mesh)."""
        if shard is None or (shard.member and self.rules is None):
            cache = self._init_cache(slots)
            axes = self.model.cache_slot_axes(cache)
        else:
            plan = self._plan_for_slots(slots)
            meta = plan.avals()
            axes = self.model.cache_slot_axes(meta)
            cache = None
            if shard.member:
                dims = plan.model_dims(self.rules, shard.size)
                cache = plan.unflatten([
                    torch.zeros(part.local_shape(t.shape, d, shard.size),
                                dtype=t.dtype, device=self.device)
                    for t, d in zip(plan.leaves(meta), dims)])
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=self.device)
        graph_pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        return _Pool(slots, next(_GENERATIONS), cache, axes, zeros(slots),
                     zeros(3, slots), graph_pool, shard,
                     mesh_fingerprint(shard.mesh) if shard else None, params)

    def _plan_for_slots(self, slots: int) -> part.ShardingPlan:
        """The pooled cache's plan at ``slots`` slots: shapes from a
        ``meta`` build, no device allocation (memoized)."""
        with self._plan_lock:
            if slots not in self._cache_plans:
                meta = self._init_cache(slots, device="meta")
                self._cache_plans[slots] = part.ShardingPlan.of(
                    meta, self._cache_specs(slots))
            return self._cache_plans[slots]

    def _cache_specs(self, slots: int) -> PyTree:
        """Logical specs of ``_init_cache``'s tree (hook: enc-dec)."""
        return self.model.cache_logical_specs(slots, self.cfg.max_len)

    def _pool_for(self, slots: int, mesh=None, live: bool = True,
                  moved=None) -> _Pool:
        """The pool of ``slots`` slots on ``mesh`` (``live``: the engine's
        own mesh): the live pool, or a candidate that the next resize or
        reshard to it takes over.  A candidate on another mesh holds the
        params moved there ahead: ``moved`` (``_params_for``'s), the last
        candidate's on that mesh, or moved now (every rank calls this
        together).  One candidate at a time: staging another drops the
        last one's entries."""
        if live:
            mesh = self.mesh
        fp = mesh_fingerprint(mesh)
        if slots == self._pool.slots and fp == self._pool.fp:
            return self._pool
        staged = self._staged
        if staged is not None and (staged.slots, staged.fp) == (slots, fp):
            return staged
        if staged is not None:
            self._exec.evict(lambda k: k[2] == staged.gen)
            self._staged = None
        if fp == self._pool.fp:
            shard, params = self._pool.shard, self.params
        elif staged is not None and staged.fp == fp:
            shard, params = staged.shard, staged.params
        elif moved is not None:
            shard, params = moved
        else:
            shard, params = self._moved_to(mesh, self.params, self._shard)
        self._staged = self._new_pool(slots, shard, params)
        return self._staged

    def _moved_to(self, mesh, params, shard):
        """(the ``TPShard`` on ``mesh``, ``params`` of layout ``shard``
        moved there).  Every rank calls it together."""
        new = part.TPShard.of(mesh) if mesh is not None else None
        return new, move_tree(params, self._param_plan(), self.rules,
                              self.device, shard, new)

    def _params_for(self, mesh):
        """For ``warm_compile``: the params moved onto a candidate ``mesh``
        (``_moved_to``), or None where the live or the staged pool already
        holds them there.  The move's collectives run outside the engine's
        lock: a warm-up on another thread then never holds the lock that a
        serving step takes while it waits on another rank's step.  A
        fabric's recomposition waits for the warm-ups in flight, so no
        reshard runs beside this and every rank moves the same layout."""
        fp = mesh_fingerprint(mesh)
        with self._lock:
            staged = self._staged
            if fp == self._pool.fp or (staged is not None
                                       and staged.fp == fp):
                return None
            params, shard = self.params, self._shard
        with self._on_stream():
            return self._moved_to(mesh, params, shard)

    # ------------------------------------------------------------------
    # placement on a mesh: local shards, moved between sub-meshes
    # ------------------------------------------------------------------
    def _param_plan(self) -> part.ShardingPlan:
        """The whole params' plan, captured from the first tree this
        engine held whole (every rank, before any mesh)."""
        if self._params_plan is None:
            self._params_plan = part.ShardingPlan.of(
                self.params, self.model.logical_specs())
        return self._params_plan

    @property
    def _member(self) -> bool:
        """False on a rank outside the engine's mesh."""
        return self._shard is None or self._shard.member

    def _move_cache(self, src: _Pool, dst: _Pool) -> None:
        """Copy the live pool's cache into ``dst`` (same slots, another
        mesh), in place: ``dst``'s tensors are the ones its steps hold."""
        plan = self._plan_for_slots(src.slots)
        moved = move_tree(src.cache, plan, self.rules, self.device,
                          src.shard, dst.shard)
        if moved is None:
            return
        for d, m in zip(plan.leaves(dst.cache), plan.leaves(moved)):
            if d.data_ptr() != m.data_ptr():
                d.copy_(m)

    def reshard_to(self, sub) -> None:
        """Migrate this engine, params and live decode state, onto a new
        sub-accelerator (a ``MeshComposer`` grant or a ``DeviceMesh``),
        computing on its first ``tp`` model columns (``apply(point.tp)``;
        all of them by default).  In-flight tokens are harvested first;
        the params (taken over from a ``warm_compile`` of the same mesh
        where there was one) and the pooled cache are gathered on the old
        mesh, broadcast from its first rank where a new rank held none of
        them, and sliced into each new rank's shards; parked requests'
        blocks move the same way; the host's tokens follow from the old
        mesh's first rank.  Host state (queues, slots, arena) is untouched,
        and the token streams are those of an engine that never moved.
        Every rank calls it together.  Without a mesh, or onto the same
        ranks, nothing moves."""
        with self._lock, self._on_stream():
            self._harvest()          # in-flight tokens live on the old mesh
            with self._obs.span("reshard"):
                self._granted = _mesh_of(sub)
                self._place(part.tp_submesh(self._granted, self._tp))
            self.reshard_count += 1
            self._obs.inc("reshards")

    def _place(self, mesh) -> None:
        """Commit the engine to ``mesh`` (see ``reshard_to``)."""
        if mesh_fingerprint(mesh) == self._mesh_fp:
            self.mesh = mesh
            return
        old = self._pool
        new = self._pool_for(old.slots, mesh, live=False)
        self._move_cache(old, new)
        if part.needs_broadcast(old.shard, new.shard):
            self._sync_tokens(old.shard.root)
        self._pool, self._staged = new, None
        self._exec.evict(lambda k: k[2] == old.gen)
        self.params = new.params
        self.mesh, self._shard = mesh, new.shard
        self._mesh_fp = new.fp
        # parked requests' blocks follow the pool onto the new layout
        self._parked = [(req, self._block_for(block))
                        for req, block in self._parked]

    def _sync_tokens(self, root: int) -> None:
        """Every live, parked and finished request's tokens and the next
        injected ones, as the rank ``root`` holds them, onto every rank (a
        rank outside the old mesh recorded placeholders).  Every rank calls
        it together."""
        import torch.distributed as dist

        reqs = list(self._active.values()) + [r for r, _ in self._parked]
        box = [({r.rid: list(r.out_tokens) for r in reqs},
                {rid: list(t) for rid, t in self._finished.items()},
                dict(self._inject))]
        dist.broadcast_object_list(box, src=root, group=part.thread_group())
        live, finished, inject = box[0]
        for r in reqs:
            r.out_tokens = list(live[r.rid])
        self._finished = {rid: list(t) for rid, t in finished.items()}
        self._inject = dict(inject)

    def _from_mesh(self, value):
        """``value`` as the engine's mesh holds it, on every rank: broadcast
        from the mesh's first rank when the mesh does not span the world
        (every rank calls this together)."""
        shard = self._shard
        if shard is None or not part.needs_broadcast(shard, None):
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=shard.root,
                                   group=part.thread_group())
        return box[0]

    def sync(self) -> None:
        """Block until this engine's device work is done: its serving
        stream (which waits on every capture's side stream)."""
        if self.stream is not None:
            self.stream.synchronize()

    def design(self) -> Dict[str, Any]:
        """The applied design point: TP degree over the grant (None: all
        of it), slot count, encode bucket ladder (none for decode)."""
        return {"tp": self._tp, "slots": self.cfg.max_slots,
                "buckets": None}

    def apply(self, sub=None,
              point: Optional[DesignPoint] = None) -> Dict[str, Any]:
        """Apply a design-point delta live.  ``sub`` moves the engine onto
        a new grant (``reshard_to``; a one-card grant, which has no mesh,
        moves nothing); ``point.tp`` narrows the grant to its first ``tp``
        model columns, resharding params and pooled state onto them (no
        mesh: recorded, nothing moves); ``point.slots`` resizes the pool,
        migrating live slots by exact copy (never below the live count,
        never above ``slot_cap``); ``point.buckets`` goes to the bucket
        hook; ``point.dp`` belongs to a replica group.  Returns the knobs
        applied."""
        point = point if point is not None else DesignPoint(cus=0)
        with self._lock, self._on_stream():
            self._harvest()             # in-flight tokens of the old pool
            applied: Dict[str, Any] = {}
            if point.tp is not None and point.tp != (self._tp or 0):
                self._tp = max(int(point.tp), 1)
                applied["tp"] = self._tp
            if _mesh_of(sub) is not None or (
                    "tp" in applied and self._granted is not None):
                self.reshard_to(sub if sub is not None else self._granted)
            if point.slots is not None and \
                    int(point.slots) != self.cfg.max_slots:
                applied["slots"] = self._resize_slots(int(point.slots))
            b = self._apply_buckets(point.buckets)
            if b is not None:
                applied["buckets"] = b
        return applied

    def _apply_buckets(self, buckets):
        """Bucket-ladder hook: plain decode has no encode phase."""
        del buckets
        return None

    def _resize_slots(self, slots: int) -> int:
        """Resize the pool live, migrating every live slot into the lowest
        new slot ids; shrinking clamps at the live occupancy."""
        live = sorted(self._active)
        cap = max(self.cfg.slot_cap, 1)
        slots = max(min(int(slots), cap), len(live), 1)
        if slots == self.cfg.max_slots:
            return slots
        with self._obs.timed("slot_migration", "slot_migration_s",
                             src=self.cfg.max_slots, dst=slots,
                             live=len(live)):
            self._do_resize_slots(slots, live)
        return slots

    def _do_resize_slots(self, slots: int, live: List[int]) -> None:
        """Callers harvest first: no step may be in flight on the old
        pool."""
        with self._lock, self._on_stream():
            mapping = {old: new for new, old in enumerate(live)}
            new = self._pool_for(slots)
            if live and self._member:
                _migrate_slots(new.cache, self._pool.cache, live, new.axes)
            old = self._pool
            self._pool, self._staged = new, None
            # the old pool's graphs hold freed addresses: never replay them
            self._exec.evict(lambda k: k[2] == old.gen)
            self.cfg = dataclasses.replace(self.cfg, max_slots=slots)
            self._cfg_key = self._config_key(slots)
            self._active = {mapping[s]: r for s, r in self._active.items()}
            for s, req in self._active.items():
                req.slot = s
            self._inject = {mapping[s]: v for s, v in self._inject.items()
                            if s in mapping}
            self._free_slots = list(range(len(live), slots))
            self._readmit_live_views()

    def _readmit_live_views(self, extra_rows: int = 0) -> None:
        """Rebuild the admission arena at the current config and re-alloc
        every live request's view at its current size; ``extra_rows``
        reserves room for a request about to be adopted."""
        pr = self._page_rows()
        need = sum(-(-self._arena_rows(r) // pr)
                   for r in self._active.values())
        need += -(-extra_rows // pr)
        arena = self._make_arena(min_pages=need)
        for req in self._active.values():
            req.view = arena.alloc(self._arena_rows(req),
                                   self._per_token_elems, ROLE_ACT)
        self.arena = arena

    # ------------------------------------------------------------------
    # cross-replica live migration: a retiring replica's requests move to
    # a sibling engine by exact cache-row copy, never by re-prefilling
    # ------------------------------------------------------------------
    def _export_slot(self, slot: int):
        """One slot's cache rows as a host-side copy (slot dim kept; a
        copy even when the cache lies on the CPU, where ``.cpu()`` would
        alias the pool); leaves without a slot axis export a placeholder.
        On a mesh, a :class:`SlotBlock` of this rank's shards."""
        tree = None
        if self._member:
            with explicit_read(), self._on_stream():
                tree = _tree_map(
                    lambda ax, t: torch.zeros(()) if ax < 0
                    else t.narrow(ax, slot, 1).to("cpu", copy=True),
                    self._slot_axes, self.cache)
        if self._shard is None:
            return tree
        return SlotBlock(tree, self._shard)

    def _block_here(self, block) -> PyTree:
        """An exported block's tree in this engine's layout (None on a rank
        outside its mesh): as it is when cut in that layout, else moved
        leaf by leaf, gathered from the block's ranks and sliced here
        (``partitioning.move_leaf``; every rank calls this together)."""
        old = block.shard if isinstance(block, SlotBlock) else None
        tree = block.tree if isinstance(block, SlotBlock) else block
        new = self._shard
        if old is None and new is None:
            return tree
        if (old is not None and new is not None and old.ranks == new.ranks
                and old.size == new.size):
            return tree
        plan = self._plan_for_slots(1)
        n = len(plan.shapes)
        axes = plan.leaves(self._slot_axes)
        leaves = plan.leaves(tree) if tree is not None else [None] * n
        dims_old = (plan.model_dims(self.rules, old.size) if old is not None
                    else [None] * n)
        dims_new = (plan.model_dims(self.rules, new.size) if new is not None
                    else [None] * n)
        out = []
        with explicit_read(), self._on_stream():
            for t, shape, dtype, ax, do, dn in zip(
                    leaves, plan.shapes, plan.dtypes, axes, dims_old,
                    dims_new):
                if ax < 0:                 # no slot axis: the placeholder
                    out.append(torch.zeros(()))
                    continue
                moved = part.move_leaf(
                    t.to(self.device) if t is not None else None, shape,
                    dtype, self.device, old, do, new, dn)
                out.append(moved.to("cpu", copy=True)
                           if moved is not None else None)
        return plan.unflatten(out) if self._member else None

    def _block_for(self, block):
        """``block`` as this engine exports it (its layout)."""
        tree = self._block_here(block)
        return tree if self._shard is None else SlotBlock(tree, self._shard)

    def _restore_slot(self, req: Request, block) -> None:
        """Write an exported block into ``req.slot`` and make it live; its
        last emitted token is host-injected, as after any harvest.  A block
        cut in another layout moves here first."""
        tree = self._block_here(block)
        if self._member:
            with explicit_read(), self._on_stream():
                _write_slot(self.cache, tree, req.slot, self._slot_axes)
        self._active[req.slot] = req
        if req.out_tokens:
            self._inject[req.slot] = req.out_tokens[-1]

    def evacuate(self) -> Tuple[List[Tuple[Request, PyTree]], List[Request]]:
        """Strip this engine of all work so sibling replicas can adopt it.
        Returns ``(live, queued)``: ``live`` is ``[(Request, host cache
        block)]`` for every active slot and every parked request,
        ``queued`` the unadmitted requests.  Finished records stay
        readable through ``results()``.  On a mesh every rank calls it
        together: the records carry the mesh's tokens."""
        with self._lock:
            self._harvest()
            if part.needs_broadcast(self._shard, None):
                # the records leave the mesh: every rank's must hold its
                # tokens, not placeholders
                self._sync_tokens(self._shard.root)
            live = []
            for slot in sorted(self._active):
                req = self._active[slot]
                live.append((req, self._export_slot(slot)))
                self.arena.free_view(req.view)
            self._active.clear()
            self._inject.clear()
            self._free_slots = list(range(self.cfg.max_slots))
            live.extend(self._parked)
            self._parked = []
            queued, self._queue = self._queue, []
        return live, queued

    def adopt_request(self, req: Request, block: PyTree) -> int:
        """Adopt a live request evacuated from a sibling replica: a fresh
        rid, its cache block in a free slot, decoding resumed exactly where
        the source stopped."""
        with self._lock:
            self._harvest()
            if not self._free_slots:
                # callers size the pool before adopting; this is the backstop
                self._resize_slots(self.cfg.max_slots + 1)
            try:
                view = self.arena.alloc(self._arena_rows(req),
                                        self._per_token_elems, ROLE_ACT)
            except AllocationError:
                # defragment: re-admit the live views with room for this one
                self._readmit_live_views(extra_rows=self._arena_rows(req))
                view = self.arena.alloc(self._arena_rows(req),
                                        self._per_token_elems, ROLE_ACT)
            rid = self._next_rid
            self._next_rid += 1
            req.rid, req.view = rid, view
            req.slot = self._free_slots.pop(0)
            self._restore_slot(req, block)
        return rid

    def adopt_queued(self, req: Request) -> int:
        """Adopt a queued request from a sibling replica: a fresh rid, no
        second count of its length (the group observed it once)."""
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        req.slot, req.view = -1, None
        self._queue.append(req)
        return rid

    def export_queued(self) -> List[Request]:
        """Hand back the unadmitted queue; live slots stay put."""
        queued, self._queue = self._queue, []
        return queued

    # ------------------------------------------------------------------
    # preemption: park a victim's device state host-side, release its
    # slot and pages, resume later with an exact continuation
    # ------------------------------------------------------------------
    def _release_slot(self, slot: int, req: Request) -> None:
        """Single exit point returning a request's slot and its arena
        reservation together."""
        if req.view is not None:
            self.arena.free_view(req.view)
            req.view = None
        self._active.pop(slot, None)
        self._inject.pop(slot, None)
        self._free_slots.append(slot)
        req.slot = -1

    def preempt_slot(self, slot: int) -> Optional[int]:
        """Save the slot's cache rows host-side, free its pages and slot,
        and park the request for re-admission."""
        with self._lock:
            self._harvest()
            req = self._active.get(slot)
            if req is None:
                return None
            block = self._export_slot(slot)
            self._release_slot(slot, req)
            self._parked.append((req, block))
            self.preempt_count += 1
            self._obs.inc("preemptions")
            return req.rid

    def _victim_slot(self) -> Optional[int]:
        """The active request with the most remaining budget (newest rid
        breaks ties); None when nothing is preemptible."""
        best = None
        for slot, req in self._active.items():
            rem = req.max_new_tokens - req.scheduled
            if rem <= 0:
                continue
            key = (rem, req.rid, slot)
            if best is None or key > best[0]:
                best = (key, slot)
        return best[1] if best is not None else None

    def preempt_one(self) -> Optional[int]:
        with self._lock:
            self._harvest()
            slot = self._victim_slot()
            if slot is None:
                return None
            return self.preempt_slot(slot)

    def _ensure_capacity(self) -> None:
        """Grow each live slot's page table to cover the next dispatch;
        page exhaustion preempts the largest-remaining victim."""
        if not self._paged:
            return
        for slot in sorted(self._active):
            req = self._active.get(slot)
            if req is None or req.view is None:
                continue
            need = self._live_rows(req)
            while True:
                try:
                    self.arena.grow(req.view, need)
                    break
                except AllocationError:
                    victim = self._victim_slot()
                    if victim is None:
                        break
                    self.preempt_slot(victim)
                    if victim == slot:
                        break

    def _resume_parked(self) -> None:
        """Re-admit preempted requests (exact state restore) while a slot
        and their pages are available."""
        harvested = False
        while self._parked and self._free_slots:
            req, block = self._parked[0]
            try:
                view = self.arena.alloc(self._arena_rows(req),
                                        self._per_token_elems, ROLE_ACT)
            except AllocationError:
                break
            if not harvested:
                self._harvest()
                harvested = True
            self._parked.pop(0)
            req.view = view
            req.slot = self._free_slots.pop(0)
            self._restore_slot(req, block)
            self._obs.inc("preempt_resumes")

    # ------------------------------------------------------------------
    # the executable cache: decode graphs and their bounds
    # ------------------------------------------------------------------
    def _dec_len(self, req: Request) -> int:
        """KV occupancy the next dispatch reads: ``pos + 1``."""
        return len(req.tokens) + req.scheduled

    def _kv_bound(self) -> int:
        longest = max((self._dec_len(r) for r in self._active.values()),
                      default=1)
        return min(_round_block(longest), self.cfg.max_len)

    def _decode_bounds(self) -> Tuple[int, ...]:
        """Static KV bounds of the step about to be dispatched: ``()`` on
        the padded path or for an arch without KV, else ``(kv_bound,)``."""
        if not self.cfg.use_kernels or self.model.cfg.attention_free:
            return ()
        return (self._kv_bound(),)

    def _full_bounds(self) -> Tuple[int, ...]:
        """Worst-case bounds (full cache capacity), always warmed."""
        if not self.cfg.use_kernels or self.model.cfg.attention_free:
            return ()
        return (self.cfg.max_len,)

    def _next_bounds(self) -> Tuple[int, ...]:
        """The current bounds one block up (clamped to capacity), warmed
        ahead of live lengths crossing the next block boundary."""
        return tuple(min(b + KV_BOUND_BLOCK, cap) for b, cap
                     in zip(self._decode_bounds(), self._full_bounds()))

    def _covering_bounds(self, bounds: Tuple[int, ...]) -> list:
        """Every block bound that dominates ``bounds`` elementwise (not
        itself), least slack first: the fallback ladder of a cold bound."""
        axes = [range(b, cap + 1, KV_BOUND_BLOCK)
                for b, cap in zip(bounds, self._full_bounds())]
        cands = sorted(itertools.product(*axes), key=lambda t: (sum(t), t))
        return [t for t in cands if t != tuple(bounds)]

    def _decode_fn(self, pool: _Pool, bounds: Tuple[int, ...]):
        """One decode step of ``pool`` from its static inputs, at its
        bounds (KV, then an enc-dec's source); the next input token per
        slot is host-injected or the previous step's device-resident
        output."""
        inputs = pool.inputs
        live = inputs[2].bool()
        toks = torch.where(inputs[1].bool(), inputs[0], pool.prev)[:, None]
        logits, _ = self.model.decode_step(
            pool.params, pool.cache, toks, use_kernels=self.cfg.use_kernels,
            kv_bound=bounds[0] if bounds else None,
            src_bound=bounds[1] if len(bounds) > 1 else None, live_mask=live,
            tp=pool.shard)
        nxt = self.model.greedy(logits, pool.shard)
        return torch.where(live, nxt, torch.zeros_like(nxt))

    def _step_state(self, pool: _Pool) -> List[torch.Tensor]:
        """The leaves a decode step changes that a later step reads: the
        positions and any recurrent state.  KV rows a step writes lie at
        or past each row's position, which no step reads before writing
        them again (a new or restored slot is written whole)."""
        cache = pool.cache
        return [cache["pos"]] + [t for kind, leaves in cache["scanned"].items()
                                 if kind == "ssm" for t in leaves.values()]

    def _capture(self, pool: _Pool, decode_once: Callable[[], torch.Tensor]
                 ) -> GraphStep:
        """Capture ``decode_once`` as a CUDA graph into the engine's graph
        memory pool, on the engine's side stream.  The warm-up steps run
        on the pool's live state, which is saved first and restored after
        them."""
        main = self.stream
        side = self._side
        saved = [t.clone() for t in self._step_state(pool)]
        tickets = None
        mc = self.model.cfg
        if self.cfg.use_kernels and not mc.attention_free:
            # the wrapper's count: one ticket per (slot, KV head, head
            # group); a rank's local heads take at most one per query head
            tickets = torch.zeros(
                max(64, ragged_ops.ticket_count(pool.slots, mc.num_heads,
                                                mc.num_kv_heads),
                    pool.slots * mc.num_heads),
                dtype=torch.int32, device=self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                decode_once()
            for t, s in zip(self._step_state(pool), saved):
                t.copy_(s)
            before = launches.counts()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collected engine's
            # graphs would be destroyed mid-capture, an operation a
            # capturing thread may not make
            collecting = gc.isenabled()
            gc.disable()
            try:
                with ragged_ops.use_tickets(tickets, side.cuda_stream):
                    graph.capture_begin(pool=pool.graph_pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = decode_once()
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            captured = {k: n - before[k]
                        for k, n in launches.counts().items()}
            launches.add({k: -n for k, n in captured.items()})
        main.wait_stream(side)
        with self._lock:
            self.graph_captures += 1
        return GraphStep(graph, out, captured, tickets)

    def _build_decode(self, pool: _Pool, bounds: Tuple[int, ...] = ()):
        """A decode step of ``pool`` at ``bounds``: a CUDA graph on the
        card, else the eager closure."""
        def decode_once():
            return self._decode_fn(pool, bounds)

        # a rank outside the pool's mesh builds the entry, never runs it
        if self.device.type != "cuda" or not graphs or not pool.member:
            return decode_once
        return self._capture(pool, decode_once)

    def _build_prefill(self, pool: _Pool, nb: int):
        """A prefill into ``pool`` of prompts padded to ``nb``: an eager
        closure (capturing it waits for the slot as a device index)."""
        del nb

        def prefill(tokens, true_len: int, slot: int):
            return self._prefill_fn(pool, tokens, true_len, slot)
        return prefill

    def _decode_key(self, pool: _Pool, cfg_key, bounds) -> Tuple:
        return ("decode", cfg_key + (pool.fp,), pool.gen, tuple(bounds))

    def _prefill_key(self, pool: _Pool, cfg_key, nb: int) -> Tuple:
        return ("prefill", cfg_key + (pool.fp,), pool.gen, nb)

    def _decode_exec(self, bounds: Tuple[int, ...] = ()):
        pool = self._pool
        key = self._decode_key(pool, self._cfg_key, bounds)
        if bounds and not self._exec.contains(key):
            # a bound never built (live lengths grew past the warm set):
            # dispatch the smallest warm bound covering it, full capacity
            # being always warm, instead of capturing on the serving path
            for cand in self._covering_bounds(bounds):
                ck = self._decode_key(pool, self._cfg_key, cand)
                if self._exec.contains(ck):
                    bounds, key = cand, ck
                    self.covering_steps += 1
                    break
        return self._exec.get_or_build(
            key, self._counted(lambda: self._build_decode(pool, bounds)))

    def _prefill_exec(self, nb: int):
        pool = self._pool
        key = self._prefill_key(pool, self._cfg_key, nb)
        self._prefill_lens.add(nb)
        return self._exec.get_or_build(
            key, self._counted(lambda: self._build_prefill(pool, nb)))

    def _candidate_mesh(self, sub, point: DesignPoint):
        """The mesh a candidate design point computes on: ``sub``'s grant
        (None: the current one) narrowed to ``point.tp`` columns (None:
        the current degree)."""
        granted = _mesh_of(sub) if sub is not None else self._granted
        return part.tp_submesh(granted,
                               point.tp if point.tp is not None else self._tp)

    def warm_compile(self, sub, point: Optional[DesignPoint] = None) -> int:
        """Build this engine's decode and known prefill steps ahead, for
        its current design point or a candidate one: ``point.slots`` a
        candidate pool, ``sub`` and ``point.tp`` a candidate mesh (None:
        the current grant and degree), onto which the params are moved
        now; the matching ``apply`` or ``reshard_to`` takes the pool over.
        Decode is warmed at the bounds about to dispatch, one block above
        them and at full capacity.  It may run on another thread while
        serving goes on: it holds the engine's device lock, and on a mesh
        moves the params outside it (under ``partitioning.collectives_on``
        a process group of the warm-up's own; every rank warms the same
        points in the same order).  Returns the builds performed."""
        point = point if point is not None else DesignPoint(cus=0)
        mesh = self._candidate_mesh(sub, point)
        moved = self._params_for(mesh)
        with self._lock, self._on_stream(), \
                self._obs.timed("warm_compile", "warm_compile_s") as sp:
            B = point.slots or self.cfg.max_slots
            pool = self._pool_for(B, mesh, live=False, moved=moved)
            key = self._config_key(B)
            built = 0
            for bounds in sorted({self._decode_bounds(), self._next_bounds(),
                                  self._full_bounds()}):
                built += self._exec.ensure(
                    self._decode_key(pool, key, bounds),
                    self._counted(lambda bounds=bounds:
                                  self._build_decode(pool, bounds)))
            for nb in sorted(tuple(self._prefill_lens)):
                built += self._exec.ensure(
                    self._prefill_key(pool, key, nb),
                    self._counted(lambda nb=nb: self._build_prefill(pool, nb)))
            if sp is not None:
                sp["builds"] = built
        return built

    def graph_pool_bytes(self) -> int:
        """Bytes the allocator holds in the graph memory pools of this
        engine's live and staged pools (0 off the card)."""
        pools = {tuple(p.graph_pool) for p in (self._pool, self._staged)
                 if p is not None and p.graph_pool is not None}
        if not pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _prefill_fn(self, pool: _Pool, tokens, true_len: int, slot: int):
        """Prefill one prompt straight into its pool slot, whose rows past
        the prompt are zeroed first (the reference writes a fresh
        single-slot cache); returns the first token on the device."""
        view = _slot_view(pool.cache, pool.axes, slot)
        _tree_map(lambda ax, t: t.zero_() if ax >= 0 else None,
                  pool.axes, view)
        logits, filled = self.model.prefill(
            pool.params, {"tokens": tokens}, view, true_len=true_len,
            use_kernels=self.cfg.use_kernels, tp=pool.shard)
        _write_slot(pool.cache, filled, slot, pool.axes)
        return self.model.greedy(logits, pool.shard)[0]

    # ------------------------------------------------------------------
    # load signals
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def preempted_depth(self) -> int:
        return len(self._parked)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active or self._inflight
                    or self._parked)

    def pending_tokens(self) -> int:
        """Decode steps still owed by active, parked and queued requests."""
        owed = sum(req.max_new_tokens - req.scheduled
                   for req in self._active.values())
        owed += sum(req.max_new_tokens - req.scheduled
                    for req, _ in self._parked)
        owed += sum(req.max_new_tokens + len(req.tokens)
                    for req in self._queue)
        return max(owed, 0)

    def queue_head_wait_s(self, now: Optional[float] = None) -> float:
        """Seconds the oldest queued request has waited (0.0 if none)."""
        stamps = [r.submitted_s for r in self._queue if r.submitted_s > 0.0]
        if not stamps:
            return 0.0
        return max((now if now is not None else time.perf_counter())
                   - min(stamps), 0.0)

    def arena_utilization(self) -> float:
        return self.arena.utilization()

    def take_step_device(self) -> Optional[Tuple[float, int]]:
        """(device seconds, tokens) of the last decode step harvested since
        the last call, on the card (from its start to its tokens' host copy
        on the serving stream: what the step cost while sharing the card);
        None off the card or when no step was harvested."""
        out, self._step_device = self._step_device, None
        return out

    def recent_lengths(self) -> Tuple[int, ...]:
        return self._recent_lens.lengths()

    def stats(self) -> Dict[str, Any]:
        return {
            "workload_class": self.workload_class,
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "pending_tokens": self.pending_tokens(),
            "arena_utilization": round(self.arena_utilization(), 4),
            "preempted": self.preempted_depth,
            "preemptions": self.preempt_count,
            "reshard_count": self.reshard_count,
            "compile_builds": self.compile_builds,
            "graph_captures": self.graph_captures,
            "covering_steps": self.covering_steps,
            "design": self.design(),
        }

    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 16) -> int:
        """Queue one request; returns its rid.  Requests that could never
        fit a slot are rejected but recorded."""
        rid = self._next_rid
        self._next_rid += 1
        toks = np.asarray(tokens, np.int32)
        self._recent_lens.append(len(toks))
        self._queue.append(Request(rid, toks, max_new_tokens,
                                   submitted_s=time.perf_counter()))
        self._obs.inc("requests_submitted")
        return rid

    def _admit(self) -> None:
        """Move queued requests into free slots while the arena admits
        them, prefill them, then resume parked requests."""
        admitted: List[Request] = []
        while self._queue and self._free_slots:
            req = self._queue[0]
            if self._oversized(req):
                req.done = True
                self._queue.pop(0)
                self._record_finished(req)
                continue
            try:
                view = self.arena.alloc(self._arena_rows(req),
                                        self._per_token_elems, ROLE_ACT)
            except AllocationError:
                break   # arena full: stay queued
            self._queue.pop(0)
            req.view = view
            req.slot = self._free_slots.pop(0)
            self._active[req.slot] = req
            admitted.append(req)
        if admitted:
            obs = self._obs
            if obs.enabled:
                now = time.perf_counter()
                for req in admitted:
                    if req.submitted_s > 0.0:
                        obs.observe("queue_wait_s", now - req.submitted_s)
            with obs.span("admit", n=len(admitted)):
                self._prefill_admitted(admitted)
        self._resume_parked()

    def _prefill_admitted(self, reqs: List[Request]) -> None:
        """Prefill the requests just admitted (hook: the enc-dec engine
        shares one batched source encode among them)."""
        for req in reqs:
            self._prefill_into_slot(req)

    def _bucketed(self, length: int) -> int:
        bucket = max(self.cfg.prefill_bucket, 8)
        return -(-length // bucket) * bucket

    def _prefill_into_slot(self, req: Request) -> None:
        """Prefill one request into its slot.  Attention archs pad the
        prompt to its bucket and pass ``true_len``: KV past the true length
        is masked by the slot's position and overwritten by later decodes.
        SSM archs carry recurrent state that padding would corrupt, so they
        prefill at the exact prompt length."""
        L = len(req.tokens)
        nb = self._bucketed(L) if self.model.cfg.ssm is None else L
        toks = np.zeros((1, nb), np.int32)
        toks[0, :L] = req.tokens
        with self._obs.timed("prefill", "prefill_s", len=L), \
                self._on_stream():
            exe = self._prefill_exec(nb)
            first = _PLACEHOLDER
            if self._member:
                first_dev = exe(self._to_device(toks), L, req.slot)
                with explicit_read():
                    first = int(first_dev.cpu())    # sync point: first token
        first = self._eos_token(first)
        req.out_tokens.append(first)
        req.scheduled = 1
        self._inject[req.slot] = first
        self._record_ttft(req)

    def _eos_token(self, tok: int) -> int:
        """A prefill's first token under EOS termination: the mesh's, on
        every rank (a rank outside it recorded a placeholder), so that
        every rank's streams and injections are the mesh's."""
        return self._from_mesh(tok) if self.cfg.eos_id >= 0 else tok

    def _record_ttft(self, req: Request) -> None:
        """The first token just reached the host: time to first token from
        the request's submit stamp."""
        if req.submitted_s > 0.0 and self._obs.enabled:
            self._obs.observe("ttft_s", time.perf_counter() - req.submitted_s)

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admit -> dispatch decode -> harvest.
        Returns [(rid, token)] newly observed on the host; under pipelined
        decode these are the previous dispatch's tokens."""
        with self._lock, self._on_stream():
            self._admit()
            if not self._active:
                self._harvest()
                sanitize_check(self)
                return self._drain_emitted()
            # the sanitizer guards the dispatch; its harvest and any
            # preemption's export are explicit reads
            with self._obs.timed("decode_step", "decode_step_s"), \
                    sanitize_guard(self.device):
                self._step_dispatch()
            out = self._drain_emitted()
        sanitize_check(self)
        obs = self._obs
        if obs.enabled:
            obs.set_gauge("slot_utilization",
                          len(self._active) / max(self.cfg.max_slots, 1))
            obs.set_gauge("arena_utilization", self.arena.utilization())
        return out

    def _step_dispatch(self) -> None:
        self._ensure_capacity()
        if not self._active:
            return
        pool = self._pool
        B = pool.slots
        pipelined = self.cfg.pipeline_decode and self.cfg.eos_id < 0
        host = np.zeros((3, B), np.int32)   # inject values, inject mask, live
        for slot, req in self._active.items():
            host[2, slot] = 1
            if not pipelined:
                host[1, slot] = 1
                host[0, slot] = req.out_tokens[-1]
            elif slot in self._inject:
                host[1, slot] = 1
                host[0, slot] = self._inject[slot]
        exe = self._decode_exec(self._decode_bounds())
        src = torch.from_numpy(host)
        cuda = self.device.type == "cuda" and self._member
        start = ready = None
        if not self._member:                # a rank outside the mesh
            host_nxt = torch.full((B,), _PLACEHOLDER, dtype=torch.int32)
        else:
            pool.inputs.copy_(src.pin_memory() if cuda else src,
                              non_blocking=cuda)
            if self._inflight is None:
                pool.prev.zero_()           # no step in flight feeds this one
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
            nxt = exe()
            pool.prev.copy_(nxt)
            if cuda:
                host_nxt = torch.empty(B, dtype=torch.int32, pin_memory=True)
                host_nxt.copy_(nxt, non_blocking=True)
                ready = torch.cuda.Event(enable_timing=True)
                ready.record(self.stream)
            else:
                host_nxt = nxt.clone()      # an entry may reuse its output
        self._inject.clear()

        entries = []
        for slot in list(self._active):
            req = self._active[slot]
            req.scheduled += 1
            finishing = req.scheduled >= req.max_new_tokens
            entries.append((slot, req, finishing))
            if pipelined and finishing:
                # length-based completion is known at dispatch time: free
                # the slot now; the token value lands at harvest
                req.done = True
                self._release_slot(slot, req)

        # harvest the PREVIOUS dispatch while this one runs; its continuing
        # slots are fed by the dispatch just made, so no re-injection
        self._harvest(register_inject=False)
        self._inflight = _Inflight(host_nxt, ready, entries, pipelined, start)
        if not pipelined or not self._active:
            self._harvest()

    def _harvest(self, register_inject: bool = True) -> None:
        """Read one in-flight dispatch's tokens back to the host."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        if inf.ready is not None:
            with explicit_read():
                inf.ready.synchronize()         # sync point: the step's tokens
                device_s = inf.start.elapsed_time(inf.ready) / 1e3
            self._step_device = (device_s, len(inf.entries))
            self._obs.observe("decode_device_s", device_s)
        nxt = inf.host.numpy()
        if not inf.pipelined:
            # EOS ends requests on the host: every rank reads the mesh's
            # tokens (a rank outside it holds placeholders)
            nxt = self._from_mesh(nxt)
        for slot, req, finishing in inf.entries:
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self._emit_buf.append((req.rid, tok))
            if inf.pipelined:
                if finishing:
                    self._record_finished(req)
                elif register_inject:
                    self._inject[slot] = tok
            elif tok == self.cfg.eos_id or \
                    len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self._release_slot(slot, req)
                self._record_finished(req)

    def _drain_emitted(self) -> List[Tuple[int, int]]:
        out, self._emit_buf = self._emit_buf, []
        if out:
            self._obs.inc("tokens_emitted", len(out))
        return out

    def _record_finished(self, req: Request) -> None:
        self._finished[req.rid] = list(req.out_tokens)
        self._evict_finished()

    def run_to_completion(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Step until idle (or ``max_steps``); returns ``snapshot()``."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        return self.snapshot()

    def results(self) -> Dict[int, List[int]]:
        """Completed (or rejected) requests' emitted tokens (the mesh's, on
        every rank)."""
        with self._lock:
            self._harvest()
            return self._from_mesh(
                {rid: list(toks) for rid, toks in self._finished.items()})

    def snapshot(self) -> Dict[int, List[int]]:
        """Every request seen so far -> tokens emitted (the mesh's, on
        every rank)."""
        with self._lock:
            self._harvest()
            out = {req.rid: list(req.out_tokens)
                   for req in list(self._active.values()) + self._queue}
            out.update({req.rid: list(req.out_tokens)
                        for req, _ in self._parked})
            out.update({rid: list(toks)
                        for rid, toks in self._finished.items()})
            return self._from_mesh(out)
