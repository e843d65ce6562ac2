"""Logical-axis partitioning of the port (``repro.distribution.partitioning``)
on a torch ``DeviceMesh``.

Model code names every parameter dim with a *logical* axis ("embed",
"heads", "mlp", "expert", ...): ``Model.logical_specs()`` gives the tree of
those names beside the parameter tree.  A :class:`ShardingRules` maps
logical names to mesh-dim names, so one model definition runs unchanged on
one device, a (data, model) mesh or a (pod, data, model) mesh: only the
rules change.

A *physical spec* is a tuple with one entry per tensor dim: None
(replicated), a mesh-dim name, or a tuple of mesh-dim names (the dim split
over each, major to minor, as ``batch -> ("pod", "data")``).  It is what
the reference's ``PartitionSpec`` holds.  :func:`placements` turns it into
DTensor placements over a ``DeviceMesh``: ``Shard(dim)`` on every mesh dim
that splits tensor dim ``dim``, ``Replicate()`` on the others.

Spec functions take a ``DeviceMesh`` or a mapping of mesh-dim name to
size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Entry = Optional[Union[str, Tuple[str, ...]]]
LogicalSpec = Tuple[Entry, ...]
Spec = Tuple[Entry, ...]
PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names -> mesh-dim name(s) (or None)."""

    rules: Mapping[str, Entry]

    def physical(self, logical: Entry) -> Entry:
        if logical is None:
            return None
        if isinstance(logical, tuple):
            out: list = []
            for name in logical:
                p = self.rules.get(name)
                if p is None:
                    continue
                out.extend(p if isinstance(p, tuple) else (p,))
            if not out:
                return None
            return tuple(out) if len(out) > 1 else out[0]
        return self.rules.get(logical)

    def spec(self, logical_spec: LogicalSpec) -> Spec:
        return tuple(self.physical(ax) for ax in logical_spec)

    def shard(self, mesh, logical_spec: LogicalSpec, shape=None) -> list:
        """Placements of a tensor of ``shape`` (fitted where given)."""
        spec = self.spec(logical_spec)
        if shape is not None:
            spec = fit_spec(spec, shape, mesh)
        return placements(spec, mesh)


# ---------------------------------------------------------------------------
# Default rule sets, the reference's tables.  Axis vocabulary:
#   batch        global batch                    -> (pod, data)
#   act_seq      residual-stream sequence dim    -> model in training
#                (sequence parallelism of the remat-saved residuals)
#   kv_seq       KV-cache sequence dim (decode)  -> model (split-K decode)
#   embed        weight d_model dim              -> data under FSDP
#   vocab        embedding / logits vocab dim    -> model
#   heads        attention query heads           -> model
#   kv_heads     attention kv heads              -> None (replicated; each
#                model rank slices the KV heads of its query heads)
#   mlp          dense FFN hidden dim            -> model
#   expert       MoE expert dim                  -> data (train) / model
#   expert_embed expert weight d_model dim       -> None / data
#   expert_mlp   expert FFN hidden dim           -> model / None
#   ssm_inner    mamba inner dim                 -> model
#   lora         MLA latent dim                  -> None
# ---------------------------------------------------------------------------

def train_rules(fsdp: bool = True, sequence_parallel: bool = True
                ) -> ShardingRules:
    """Training: DP over (pod, data); TP over model; FSDP (ZeRO-3) over
    data; expert parallelism over data; sequence-parallel residuals."""
    return ShardingRules(rules={
        "batch": ("pod", "data"),
        "act_seq": "model" if sequence_parallel else None,
        "kv_seq": None,
        "embed": "data" if fsdp else None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,
        "mlp": "model",
        "expert": "data",
        "expert_embed": None,
        "expert_mlp": "model",
        "ssm_inner": "model",
        "layers": None,
        "conv_w": None,
        "state": None,
        "lora": None,
    })


def serve_rules(fsdp_weights: bool = False) -> ShardingRules:
    """Serving: batch over (pod, data); TP over model; the KV cache split-K
    over model on its sequence dim.  ``fsdp_weights`` also shards weights'
    d_model dims over data (2-D tensor parallelism)."""
    return ShardingRules(rules={
        "batch": ("pod", "data"),
        "act_seq": None,
        "kv_seq": "model",
        "embed": "data" if fsdp_weights else None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,
        "mlp": "model",
        "expert": "model",
        "expert_embed": "data" if fsdp_weights else None,
        "expert_mlp": None,
        "ssm_inner": "model",
        "layers": None,
        "conv_w": None,
        "state": None,
        "lora": None,
    })


def serve_engine_rules() -> ShardingRules:
    """``serve_rules()`` tuned for the decode engine's composed sub-meshes:
    the KV cache shards over its kv *heads* rather than split-K over its
    sequence (a write at a per-row position into a sequence-sharded cache
    would move the whole cache every step), and head counts that do not
    divide a sub-mesh fall back to replication per leaf, so the same rules
    serve a 1-column and an 8-column composition."""
    rules = dict(serve_rules().rules)
    rules["kv_seq"] = None
    rules["kv_heads"] = "model"
    return ShardingRules(rules=rules)


def single_device_rules() -> ShardingRules:
    return ShardingRules(rules={})


# ---------------------------------------------------------------------------
# trees of specs
# ---------------------------------------------------------------------------

def tree_map_specs(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``fn(spec, *leaves)`` over a spec tree (dicts, lists, and spec
    tuples as leaves) and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def logical_specs(model) -> PyTree:
    """The model's tree of logical specs, in its parameter tree's
    structure (``Model.logical_specs``)."""
    return model.logical_specs()


def physical_specs(spec_tree: PyTree, rules: ShardingRules) -> PyTree:
    """Tree of logical specs -> tree of physical specs."""
    return tree_map_specs(rules.spec, spec_tree)


def shardings(spec_tree: PyTree, mesh, rules: ShardingRules,
              params: Optional[PyTree] = None) -> PyTree:
    """Tree of DTensor placement lists on ``mesh``: each leaf's physical
    spec, sanitized to the mesh's dims, and fitted to its tensor's shape
    where ``params`` (the tree of tensors) is given."""
    if params is None:
        return tree_map_specs(
            lambda s: placements(sanitize_spec(rules.spec(s), mesh), mesh),
            spec_tree)
    return tree_map_specs(
        lambda s, t: placements(fit_spec(rules.spec(s), t.shape, mesh),
                                mesh), spec_tree, params)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def mesh_sizes(mesh) -> dict:
    """{mesh-dim name: size} of a DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of a physical spec on ``mesh`` (its dims must be
    the mesh's; see :func:`sanitize_spec`).  A tensor dim split over
    several mesh dims takes them in the mesh's order, major first, which is
    the spec's order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out: List[Any] = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits dim {dim} over "
                             f"mesh dims out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dim {names[i]} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(dim)
    return out


def validate_divisibility(shape: Sequence[int], spec: Spec, mesh) -> bool:
    """True iff every sharded dim divides evenly on the mesh."""
    sizes = mesh_sizes(mesh)
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        total = 1
        for a in axes:
            total *= sizes[a]
        if dim % total:
            return False
    return True


def sanitize_spec(spec: Spec, mesh) -> Spec:
    """Drop mesh dims a spec references that this mesh lacks (the 'pod'
    dim on single-pod meshes, and on composed sub-meshes)."""
    names = set(mesh_sizes(mesh))

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            if not kept:
                return None
            return kept if len(kept) > 1 else kept[0]
        return entry if entry in names else None

    return tuple(keep(e) for e in spec)


def fit_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """sanitize_spec + divisibility: drop sharded mesh dims whose product
    does not evenly divide the tensor dim (hymba's 25 heads on a 16-wide
    model dim, batch 1, odd vocabularies); replication is the graceful
    degradation."""
    spec = sanitize_spec(spec, mesh)
    sizes = mesh_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def fit(dim, entry):
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept, prod = [], 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            return None
        return tuple(kept) if len(kept) > 1 else kept[0]

    return tuple(fit(d, e) for d, e in zip(shape, entries))


def _mesh_key(names, ranks: torch.Tensor) -> tuple:
    return (tuple(names), tuple(ranks.shape),
            tuple(int(r) for r in ranks.flatten()))


def _family(mesh) -> dict:
    """The sub-meshes carved from ``mesh`` and from the mesh it was carved
    from, by (dim names, rank grid), the root included.  The dict is kept
    on each of them, so a recomposition that lands on a rank set seen
    before takes its mesh and never creates the same process groups
    twice, and the dict goes with the meshes of its world."""
    fam = getattr(mesh, "_sub_meshes", None)
    if fam is None:
        fam = {_mesh_key(mesh.mesh_dim_names, mesh.mesh): mesh}
        mesh._sub_meshes = fam
    return fam


def _sub_mesh(mesh, idx):
    """A DeviceMesh over ``mesh.mesh[idx]`` with the same dim names,
    created once per rank grid of ``mesh``'s family (``_family``).  Every
    rank of the world calls it in the same order (a new one creates
    process groups); a rank outside the slice gets a mesh it is not part
    of."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.mesh[idx]
    fam = _family(mesh)
    key = _mesh_key(mesh.mesh_dim_names, ranks)
    if key not in fam:
        sub = DeviceMesh(mesh.device_type, ranks,
                         mesh_dim_names=mesh.mesh_dim_names)
        sub._sub_meshes = fam
        fam[key] = sub
    return fam[key]


def tp_submesh(mesh, degree: Optional[int], axis: str = "model"):
    """Restrict a mesh's ``axis`` to its first ``degree`` columns (a
    tenant's tensor-parallel degree below its CU grant).  ``degree`` None
    or 0, or >= the axis size, returns the mesh unchanged; a mesh without
    ``axis`` is returned as it is."""
    if mesh is None or not degree or axis not in mesh.mesh_dim_names:
        return mesh
    ax = mesh.mesh_dim_names.index(axis)
    if degree >= mesh.mesh.shape[ax]:
        return mesh
    idx = [slice(None)] * mesh.mesh.ndim
    idx[ax] = slice(0, degree)
    return _sub_mesh(mesh, tuple(idx))


def replica_submesh(mesh, index: int, replicas: int, axis: str = "model"):
    """Tile ``index`` of ``replicas`` disjoint equal-width tiles of
    ``mesh`` along ``axis`` (columns past ``replicas * (size //
    replicas)`` idle).  ``replicas`` <= 1, or a mesh without ``axis``,
    returns the mesh as it is."""
    if mesh is None or replicas <= 1 or axis not in mesh.mesh_dim_names:
        return mesh
    ax = mesh.mesh_dim_names.index(axis)
    width = mesh.mesh.shape[ax] // replicas
    if width < 1:
        raise ValueError(
            f"cannot tile {mesh.mesh.shape[ax]} '{axis}' columns into "
            f"{replicas} replica slices")
    if not 0 <= index < replicas:
        raise ValueError(f"replica index {index} out of range for "
                         f"{replicas} replicas")
    idx = [slice(None)] * mesh.mesh.ndim
    idx[ax] = slice(index * width, (index + 1) * width)
    return _sub_mesh(mesh, tuple(idx))


def row_submeshes(mesh, axis: str = "model") -> list:
    """The sub-mesh of each row of ``mesh`` along ``axis`` (``axis`` whole,
    one index on every other dim: a production mesh's data rows), in
    row-major order.  Every rank calls it in the same order."""
    ax = mesh.mesh_dim_names.index(axis)
    others = [range(n) for i, n in enumerate(mesh.mesh.shape) if i != ax]
    rows = []
    for coords in itertools.product(*others):
        idx = [slice(c, c + 1) for c in coords]
        idx.insert(ax, slice(None))
        rows.append(_sub_mesh(mesh, tuple(idx)))
    return rows


# ---------------------------------------------------------------------------
# DTensors
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, rules: ShardingRules, logical: LogicalSpec):
    """Pin a DTensor's layout by logical axes (a ``redistribute`` to the
    fitted placements); a plain tensor is returned as it is."""
    return constrain_spec(x, rules.spec(logical))


def constrain_spec(x, spec: Optional[Spec]):
    """``constrain`` by a physical spec (None: as it is)."""
    if spec is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(fit_spec(spec, x.shape, mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _grouped(x, dim: int, groups: Optional[int]):
    """Replicate each mesh dim that splits ``dim`` into a count that does
    not divide ``groups`` (None: every split, a 1-wide one too)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    want = [Replicate() if p.is_shard(dim) and (
        groups is None or groups % mesh.size(i)) else p
        for i, p in enumerate(x.placements)]
    if want == list(x.placements):
        return x
    return x.redistribute(mesh, want)


class _GroupedGrad(torch.autograd.Function):
    """Identity whose gradient is laid out as ``_grouped`` lays out the
    value, so that the backward of a view can take it."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _grouped(g, ctx.dim, ctx.groups), None, None


def whole_groups(x, dim: int, groups: Optional[int]):
    """A DTensor whose shards of ``dim`` hold whole groups of ``groups``
    (heads of a flattened heads x head-dim axis, before it is unflattened;
    None: ``dim`` whole), and whose gradient does too: a mesh dim that
    splits ``dim`` into a count that does not divide ``groups`` is
    replicated.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    dim = dim % x.ndim
    return _GroupedGrad.apply(_grouped(x, dim, groups), dim, groups)


def unshard(x, dim: int):
    """A DTensor with ``dim`` whole on every rank, value and gradient
    (each mesh dim that splits it replicated, a 1-wide one too), for ops
    that flatten or reduce over it; a plain tensor as it is."""
    return whole_groups(x, dim, None)


def rows_matmul(x, w):
    """``x @ w`` for (..., S, K) rows: on a mesh the sequence dim of the
    operand, the product and their gradients whole (DTensor flattens
    (B, S) into one dim around the product, which a split S refuses)."""
    if not is_dtensor(x) or x.ndim < 3:
        return x @ w
    return unshard(unshard(x, -2) @ w, -2)


def rows_only(x, lead: int):
    """A DTensor split, if at all, over its ``lead`` leading dims (the
    rows: batch, sequence): every other split, and every partial sum,
    resolved to whole values on each rank."""
    from torch.distributed.tensor import Replicate

    want = [p if p.is_shard() and p.dim < lead else Replicate()
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _row_grads(placements) -> list:
    """Gradient placements of a tensor replicated on every rank that
    serves each rank's own rows: a partial sum over the mesh dims that
    split the rows, whole over the others."""
    from torch.distributed.tensor import Partial, Replicate

    return [Partial() if p.is_shard() else Replicate() for p in placements]


def lookup(table, idx):
    """``table[idx]`` for a DTensor table and DTensor indices: the table
    gathered whole on each rank, each rank's rows looked up in its local
    copy, and the table's gradient a partial sum over the mesh dims that
    split the indices, reduced back onto the table's layout."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = table.device_mesh
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=_row_grads(idx.placements))
    rows = whole[idx.to_local().long()]
    return DTensor.from_local(rows, mesh, list(idx.placements),
                              run_check=False)


def row_sum(fn, x, *rows, lead: int = 2):
    """``fn(x, *rows)``, a sum over rows, run on each rank's local rows of
    DTensors: ``x`` laid out by ``rows_only``, each of ``rows`` as ``x``'s
    leading dims.  The result is a partial sum over the mesh dims that
    split the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    x = rows_only(x, lead)
    mesh = x.device_mesh
    place = list(x.placements)
    local = [r.redistribute(mesh, place).to_local() if is_dtensor(r) else r
             for r in rows]
    out = fn(x.to_local(), *local)
    return DTensor.from_local(
        out, mesh, [Partial() if p.is_shard() else Replicate()
                    for p in place], run_check=False)


# The layout the per-channel kernels run in on a mesh (the Mamba scan):
# batch over the data dims, channels over the model dim.
_CHANNEL_LAYOUT = ShardingRules({"batch": ("pod", "data"),
                                 "ssm_inner": "model"})


def channel_local(fn, chans, shared=(), weights=(), weight_dims=None):
    """``fn(*chans, *shared, *weights)``, a function whose every output
    channel depends on its own channel alone, run on each rank's own rows
    and channels of DTensors (plain tensors: called as it is).

    - ``chans``, (B, S, C): batch on the data dims, channels on the model
      dim, S whole; their gradients laid out alike.
    - ``shared``, (B, S, N), read by every channel: batch on the data
      dims, whole over the model dim; their gradients a partial sum over
      the mesh dims that split the channels.
    - ``weights``, per channel along dim ``weight_dims[i]`` (default 0):
      channels on the model dim, whole over the data dims; their gradients
      a partial sum over the mesh dims that split the rows.

    ``fn`` returns one (B, S, C) tensor or a tuple of them, which come back
    as DTensors laid out as ``chans``.  A dim that its mesh dims do not
    divide stays whole (``fit_spec``)."""
    if not is_dtensor(chans[0]):
        return fn(*chans, *shared, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = chans[0].device_mesh
    place = placements(fit_spec(_CHANNEL_LAYOUT.spec(
        ("batch", None, "ssm_inner")), chans[0].shape, mesh), mesh)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in place]
    row_grads = [Partial() if p.is_shard(2) else q
                 for p, q in zip(place, rows)]
    local = [t.redistribute(mesh, place).to_local() for t in chans]
    local += [t.redistribute(mesh, rows).to_local(grad_placements=row_grads)
              for t in shared]
    for t, dim in zip(weights, weight_dims or (0,) * len(weights)):
        cols = [Shard(dim) if p.is_shard(2) else Replicate() for p in place]
        local.append(t.redistribute(mesh, cols).to_local(grad_placements=[
            Partial() if p.is_shard(0) else q for p, q in zip(place, cols)]))
    out = fn(*local)
    wrap = lambda y: DTensor.from_local(y, mesh, place, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def split_over(x, dim: int) -> bool:
    """True when a mesh dim wider than one splits ``dim`` of DTensor
    ``x`` (False for a plain tensor)."""
    if not is_dtensor(x):
        return False
    mesh = x.device_mesh
    return any(p.is_shard(dim % x.ndim) and mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def resolved(x):
    """A DTensor with every partial sum reduced (whole on those mesh
    dims); a plain tensor as it is."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def distribute(t: torch.Tensor, mesh, place) -> Any:
    """The local shard of a full tensor that every rank holds alike (no
    communication: each rank keeps its own chunk)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, place, src_data_rank=None)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """The sharding skeleton of a parameter tree: per leaf (path, shape,
    dtype, logical spec), captured once and fitted to any mesh.
    ``shardings(mesh, rules)`` gives the tree of placement lists, ``avals``
    the tree of ``meta`` tensors of the leaves' shapes and dtypes."""

    spec_tree: PyTree
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    logicals: Tuple[Optional[LogicalSpec], ...]

    @classmethod
    def of(cls, params: PyTree, spec_tree: PyTree) -> "ShardingPlan":
        shapes, dtypes, logicals = [], [], []

        def visit(spec, t):
            shapes.append(tuple(t.shape))
            dtypes.append(t.dtype)
            logicals.append(spec)
            return spec

        tree_map_specs(visit, spec_tree, params)
        return cls(spec_tree, tuple(shapes), tuple(dtypes), tuple(logicals))

    @property
    def annotated(self) -> bool:
        return any(l is not None for l in self.logicals)

    def specs(self, mesh, rules: ShardingRules) -> list:
        return [fit_spec(rules.spec(l) if l is not None else (), shape, mesh)
                for shape, l in zip(self.shapes, self.logicals)]

    def _unflatten(self, leaves: list) -> PyTree:
        it = iter(leaves)
        return tree_map_specs(lambda _: next(it), self.spec_tree)

    def shardings(self, mesh, rules: ShardingRules) -> PyTree:
        return self._unflatten([placements(s, mesh)
                                for s in self.specs(mesh, rules)])

    def avals(self) -> PyTree:
        return self._unflatten([torch.empty(s, dtype=d, device="meta")
                                for s, d in zip(self.shapes, self.dtypes)])

    def leaves(self, tree: PyTree) -> list:
        """``tree``'s leaves in this plan's order."""
        out: list = []
        tree_map_specs(lambda _, t: out.append(t), self.spec_tree, tree)
        return out

    def unflatten(self, leaves: list) -> PyTree:
        return self._unflatten(leaves)

    def model_dims(self, rules: Optional[ShardingRules],
                   size: int) -> List[Optional[int]]:
        """Each leaf's dim split over a ``size``-wide model dim
        (``model_dim``)."""
        return [model_dim(l, shape, rules, size)
                for shape, l in zip(self.shapes, self.logicals)]


# ---------------------------------------------------------------------------
# tensor-parallel serving: local shards and explicit collectives
#
# A serving engine on a mesh holds plain tensors, each rank its own shard,
# and runs its steps with explicit ``torch.distributed`` collectives over
# the mesh's "model" dim (DTensor dispatch stays off the decode hot path and
# out of graph capture).  A leaf is split over "model" on at most one dim:
# the first dim its rules put on "model" whose size the model dim divides;
# any other leaf is whole on every rank.  The mesh's other dims (a
# production mesh's data rows) hold replicas: each row runs the same
# tensor-parallel step.
# ---------------------------------------------------------------------------

class Blocks(tuple):
    """A logical spec whose dim on "model" is ``blocks`` equal tensors
    concatenated: Mamba's ``in_proj`` (d, 2 d_in), its x columns then its
    z columns on one "ssm_inner" dim.  It compares equal to the plain
    spec (the reference's annotation); a serving rank's shard of such a
    dim is the same slice of each block, concatenated (``model_dim``,
    ``TPShard.local``), so that its x and z columns are those of its own
    channels."""

    def __new__(cls, spec, blocks: int = 2):
        out = super().__new__(cls, spec)
        out.blocks = blocks
        return out

    def __getnewargs__(self):
        return tuple(self), self.blocks


class BlockDim(int):
    """A leaf's dim split over the model group, made of ``blocks`` equal
    blocks, each split alike (``Blocks``)."""

    def __new__(cls, dim: int, blocks: int):
        out = super().__new__(cls, dim)
        out.blocks = blocks
        return out

    def __getnewargs__(self):
        return int(self), self.blocks


def _blocks_of(dim) -> int:
    return getattr(dim, "blocks", 1)


def model_dim(logical: Optional[LogicalSpec], shape: Sequence[int],
              rules: Optional[ShardingRules], size: int) -> Optional[int]:
    """The dim of a leaf of ``shape`` that ``rules`` split over a
    ``size``-wide model dim, or None (whole): no rules, a 1-wide model
    dim, or no dim on "model" that ``size`` divides.  A ``Blocks`` spec's
    dim is split where ``size`` divides each block, and comes back as a
    ``BlockDim``."""
    if rules is None or logical is None or size <= 1:
        return None
    blocks = _blocks_of(logical)
    for dim, (n, entry) in enumerate(zip(shape, rules.spec(logical))):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "model" in axes and n % (size * blocks) == 0:
            return BlockDim(dim, blocks) if blocks > 1 else dim
    return None


@dataclasses.dataclass(frozen=True)
class TPShard:
    """This rank's place on a serving mesh: the mesh's ranks (row-major),
    whether this rank is one of them, and its tensor-parallel group over
    the "model" dim (its own row), that group's size and this rank's index
    in it.  A rank outside the mesh holds none of an engine's tensors."""

    mesh: Any
    ranks: Tuple[int, ...]
    member: bool
    size: int
    index: int
    group: Any = None

    @classmethod
    def of(cls, mesh) -> "TPShard":
        import torch.distributed as dist

        ranks = tuple(int(r) for r in mesh.mesh.flatten())
        names = list(mesh.mesh_dim_names)
        size = mesh.mesh.shape[names.index("model")] if "model" in names \
            else 1
        member = dist.get_rank() in ranks
        if not member or "model" not in names:
            return cls(mesh, ranks, member, size, 0 if member else -1)
        return cls(mesh, ranks, True, size, mesh.get_local_rank("model"),
                   mesh.get_group("model") if size > 1 else None)

    @property
    def root(self) -> int:
        """The mesh's first rank (global): the source of broadcasts."""
        return self.ranks[0]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model group in place (a partial sum of a
        row-parallel product); a no-op on a 1-wide group."""
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's shards of ``x`` concatenated along ``dim``,
        in rank order."""
        if self.size <= 1:
            return x
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return _join(parts, dim)

    def local(self, full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's shard of a whole tensor (the tensor itself when it
        stays whole; a copy of the slice otherwise, so that the whole one
        can be freed); of a ``BlockDim``, its slice of each block."""
        if dim is None:
            return full
        blocks = _blocks_of(dim)
        n = full.shape[dim] // (self.size * blocks)
        if blocks == 1:
            return full.narrow(dim, self.index * n, n).clone()
        return torch.cat([b.narrow(dim, self.index * n, n)
                          for b in full.chunk(blocks, dim)], dim=dim)


def _join(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The model group's shards, in rank order, as the whole tensor."""
    blocks = _blocks_of(dim)
    if blocks == 1:
        return torch.cat(list(parts), dim=dim)
    # each rank's shard holds its slice of every block, in block order
    split = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([s[b] for b in range(blocks) for s in split], dim=dim)


def local_shape(shape: Sequence[int], dim: Optional[int],
                size: int) -> Tuple[int, ...]:
    out = list(shape)
    if dim is not None:
        out[dim] //= size
    return tuple(out)


def _world_ranks() -> Tuple[int, ...]:
    import torch.distributed as dist

    return tuple(range(dist.get_world_size()))


def needs_broadcast(old: Optional[TPShard], new: Optional[TPShard]) -> bool:
    """True when a rank that will hold the new layout held none of the
    old one (every rank holds whole tensors where the shard is None)."""
    if old is None:
        return False
    holders = set(new.ranks) if new is not None else set(_world_ranks())
    return not holders <= set(old.ranks)


# The process group a thread's ``move_leaf`` calls run their collectives
# on, where it is not the default one (``collectives_on``).
_THREAD = threading.local()


@contextlib.contextmanager
def collectives_on(group):
    """Run this thread's ``move_leaf`` calls (and the engines' token
    broadcasts) over ``group`` (a process group over the whole world),
    ``move_leaf`` by broadcasts alone: each shard of the old
    layout from its holder, a whole leaf from the old mesh's first rank.
    A second thread (a fabric's background warm-up) then issues none of
    its collectives on the groups the serving thread uses, whose
    collectives would otherwise interleave with its own in a different
    order on each rank."""
    prev = getattr(_THREAD, "group", None)
    _THREAD.group = group
    try:
        yield
    finally:
        _THREAD.group = prev


def thread_group():
    """The process group this thread's collectives run on (None: the
    default one)."""
    return getattr(_THREAD, "group", None)


def _whole_on(group, t: Optional[torch.Tensor], shape: Sequence[int],
              dtype: torch.dtype, device, old: TPShard,
              old_dim: Optional[int]) -> torch.Tensor:
    """The whole leaf on every rank of ``group``: each shard of the old
    mesh's first row broadcast from its holder (a leaf split over the
    "model" dim, the mesh's last), or the leaf from the old mesh's first
    rank.  Every rank calls it with the same layout."""
    import torch.distributed as dist

    me = dist.get_rank()
    if old_dim is None:
        full = (t if me == old.root
                else torch.empty(tuple(shape), dtype=dtype, device=device))
        dist.broadcast(full, src=old.root, group=group)
        return full
    piece = local_shape(shape, old_dim, old.size)
    parts = []
    for src in old.ranks[:old.size]:
        buf = (t.contiguous() if me == src
               else torch.empty(piece, dtype=dtype, device=device))
        dist.broadcast(buf, src=src, group=group)
        parts.append(buf)
    return _join(parts, old_dim)


def move_leaf(t: Optional[torch.Tensor], shape: Sequence[int],
              dtype: torch.dtype, device, old: Optional[TPShard],
              old_dim: Optional[int], new: Optional[TPShard],
              new_dim: Optional[int]) -> Optional[torch.Tensor]:
    """One leaf from the ``old`` layout to the ``new`` one: gathered whole
    within the old model group, broadcast from the old mesh's first rank
    to every rank where a new holder held none of it, and sliced by each
    new holder (under ``collectives_on``, broadcast whole to every rank
    over that group instead).  Returns this rank's new local tensor (None
    on a rank outside ``new``).  Every rank of the world calls it with the
    same layouts."""
    import torch.distributed as dist

    group = thread_group()
    if group is not None and old is not None:
        full = _whole_on(group, t, shape, dtype, device, old, old_dim)
        if new is None:
            return full
        return new.local(full, new_dim) if new.member else None
    full = t
    if old is not None and old.member:
        full = old.all_gather(t, old_dim) if old_dim is not None else t
    if needs_broadcast(old, new):
        if old is None or not old.member:
            full = torch.empty(tuple(shape), dtype=dtype, device=device)
        dist.broadcast(full, src=old.root)
    if new is None:
        return full
    if not new.member:
        return None
    return new.local(full, new_dim)
