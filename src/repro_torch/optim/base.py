"""Optimizers of the port (``repro.optim.base``): AdamW, factored
Adafactor, global-norm clipping and the cosine schedule, with the
reference's formulas.  ``make_optimizer(cfg)`` picks AdamW (the default)
or Adafactor (qwen1.5-110b, arctic-480b).

Parameters are the port's tree: dicts, and lists of per-layer dicts.  The
reference stacks its scanned layers' leaves on a leading layer axis, and
its rules read the stacked shape, so here the leaves of a list under the
key ``layers`` (the decoder's and an encoder's scanned stacks) form one
group per leaf path, counted as their stack:

- AdamW decays a leaf whose stacked rank is at least 2 (``ndim + 1`` for
  a stacked leaf): a layer's norm scale and bias are decayed, the final
  norm's are not, as in the reference.
- Adafactor factors a stacked leaf over the stack of its per-layer copies:
  a stacked (L, d) leaf keeps a row statistic (L,) and a column statistic
  (d,) that is a mean over the layers, and the update-clip RMS is taken
  over the whole stack.

The prologue (a list under another key) is unstacked, as in the reference.
Updates run IN PLACE on the parameters and their states, one leaf at a
time and in bounded chunks (AdamW), so a full-width model trains with no
second copy of a parameter; ``torch.optim`` is not used, since its state
layout and decay rule are not the reference's.

DTensor parameters (a mesh): AdamW's states take each parameter's layout
and its count is replicated; the update runs on each rank's local shards
(a gradient is first laid out as its parameter), elementwise as on one
device.  Clipping's norm is a DTensor reduction.  Adafactor's statistics
take their parameter's layout less the dim they average over, and its
means over split dims are summed over the mesh dims that split them: both
optimizers run on a mesh, for every family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import torch_dtype

PyTree = Any
_CHUNK = 1 << 26        # AdamW's elements per in-place pass (256 MB fp32)


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]   # (grads, state, params, lr)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """Tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def leaf_groups(tree: PyTree, path=()) -> Iterator[Tuple[str, List, bool]]:
    """(name, tensors, stacked) per group: one stacked group per leaf path
    of a list under ``layers`` (its per-layer tensors in layer order),
    one unstacked group per other leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_groups(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        if path and path[-1] == "layers" and tree:
            for sub in _paths(tree[0]):
                yield (".".join(map(str, path + sub)),
                       [_at(layer, sub) for layer in tree], True)
        else:
            for i, v in enumerate(tree):
                yield from leaf_groups(v, path + (i,))
    else:
        yield ".".join(map(str, path)), [tree], False


# ---------------------------------------------------------------------------
# gradient utilities
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor, like=None) -> torch.Tensor:
    """A DTensor's local shard, laid out as ``like`` first where given; a
    plain tensor as it is."""
    from repro_torch.distribution.partitioning import is_dtensor

    if not is_dtensor(t):
        return t
    if like is not None and t.placements != like.placements:
        t = t.redistribute(like.device_mesh, like.placements)
    return t.to_local()


def _count_like(leaf: torch.Tensor) -> torch.Tensor:
    """An int32 step count on ``leaf``'s device (replicated on its mesh)."""
    from repro_torch.distribution.partitioning import distribute, is_dtensor

    count = torch.zeros((), dtype=torch.int32,
                        device=_local(leaf).device)
    if not is_dtensor(leaf):
        return count
    from torch.distributed.tensor import Replicate

    mesh = leaf.device_mesh
    return distribute(count, mesh, [Replicate()] * mesh.ndim)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's value whole on every rank, as a plain tensor."""
    from repro_torch.distribution.partitioning import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor;
    each DTensor leaf's sum reduced over the mesh first)."""
    leaves = tree_leaves(tree)
    sq = [_whole(torch.sum(torch.square(x.float()))) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scale every leaf IN PLACE by min(1, max_norm / norm); returns
    (tree, norm before clipping).  DTensor leaves scale their local
    shards."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    # a bf16 leaf is scaled in fp32 and rounded, as the reference does
    torch._foreach_mul_([_local(t) for t in tree_leaves(tree)], scale)
    return tree, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"       # bf16 states halve their memory


def _flat_chunks(*ts):
    """Matching 1-D views of at most ``_CHUNK`` elements of each tensor."""
    flat = [t.view(-1) for t in ts]
    n = flat[0].numel()
    for lo in range(0, n, _CHUNK):
        yield [f[lo:lo + _CHUNK] for f in flat]


def adamw(cfg: AdamWConfig = AdamWConfig()) -> Optimizer:
    sdt = torch_dtype(cfg.state_dtype)

    def init(params):
        zeros = lambda p: torch.zeros_like(
            p, dtype=sdt, memory_format=torch.contiguous_format)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count_like(tree_leaves(params)[0])}

    def update(grads, state, params, lr):
        with torch.no_grad():
            count = _local(state["count"])
            count.add_(1)
            count = count.float()
        b1c = 1.0 - cfg.b1 ** count
        b2c = 1.0 - cfg.b2 ** count
        groups = zip(leaf_groups(grads), leaf_groups(state["m"]),
                     leaf_groups(state["v"]), leaf_groups(params))
        with torch.no_grad():
            for (_, gs, stacked), (_, ms, _), (_, vs, _), (_, ps, _) \
                    in groups:
                for g, m, v, p in zip(gs, ms, vs, ps):
                    decay = p.ndim + int(stacked) >= 2
                    local = (_local(g, p), _local(m), _local(v), _local(p))
                    for gc, mc, vc, pc in _flat_chunks(*local):
                        g32 = gc.float()
                        # fp32 states and params update in place (.float()
                        # is then the tensor itself); others via a copy
                        m32 = mc.float().mul_(cfg.b1).add_(g32,
                                                           alpha=1 - cfg.b1)
                        v32 = vc.float().mul_(cfg.b2).addcmul_(
                            g32, g32, value=1 - cfg.b2)
                        step = (m32 / b1c).div_(
                            torch.sqrt(v32 / b2c).add_(cfg.eps))
                        if decay:   # decoupled weight decay on matrices
                            step.add_(pc.float(), alpha=cfg.weight_decay)
                        p32 = pc.float().sub_(step, alpha=lr)
                        for dst, src in ((mc, m32), (vc, v32), (pc, p32)):
                            if dst is not src:
                                dst.copy_(src)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, beta1 = 0)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8          # t^-decay running-average schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _stat_placements(place, ndim: int, stacked: bool) -> Tuple[list, list]:
    """DTensor placements of a factored leaf's (vr, vc) on a mesh, from its
    parameter's ``place``: the stacked leaf's (one dim more where
    ``stacked``) less the dim each averages over (vr the last, vc the one
    before), a mesh dim that split it whole."""
    from torch.distributed.tensor import Replicate, Shard

    off = int(stacked)

    def drop(gone: int):
        out = []
        for p in place:
            d = p.dim + off if p.is_shard() else None
            out.append(Replicate() if d is None or d == gone
                       else Shard(d - int(d > gone)))
        return out

    return drop(ndim - 1), drop(ndim - 2)


class _Split(NamedTuple):
    """Where a stacked group's leaves lie on a mesh: the process groups of
    the mesh dims (wider than one) that split each dim of the stacked
    leaf, and its whole shape (``groups`` empty: one device)."""
    groups: Tuple[tuple, ...]
    shape: Tuple[int, ...]

    @classmethod
    def of(cls, leaf, n: int, stacked: bool) -> "_Split":
        from repro_torch.distribution.partitioning import is_dtensor

        shape = ((n,) if stacked else ()) + tuple(leaf.shape)
        if not is_dtensor(leaf):
            return cls(((),) * len(shape), shape)
        mesh, off = leaf.device_mesh, int(stacked)
        return cls(tuple(tuple(mesh.get_group(i)
                               for i, p in enumerate(leaf.placements)
                               if p.is_shard(d - off) and mesh.size(i) > 1)
                         if d >= off else () for d in range(len(shape))),
                   shape)

    def mean(self, x, dim: int, along: int, keepdim: bool = False):
        """``x.mean(dim)`` of a local shard, ``dim`` of x being the stacked
        leaf's dim ``along``: where mesh dims split it, the local sums
        summed over their groups and divided by its whole size."""
        if not self.groups[along]:
            return x.mean(dim=dim, keepdim=keepdim)
        import torch.distributed as dist

        total = x.sum(dim=dim, keepdim=keepdim)
        for g in self.groups[along]:
            dist.all_reduce(total, group=g)
        return total / self.shape[along]

    def mean_all(self, x):
        """The mean over the whole stacked leaf of a local shard ``x``."""
        groups = {id(g): g for gs in self.groups for g in gs}
        if not groups:
            return torch.mean(x)
        import torch.distributed as dist

        total = x.sum()
        for g in groups.values():
            dist.all_reduce(total, group=g)
        return total / math.prod(self.shape)


def adafactor(cfg: AdafactorConfig = AdafactorConfig()) -> Optimizer:
    """State per group, keyed by its dotted path: a stacked group's
    statistics are those of the reference's stacked leaf.  On a mesh each
    statistic is a DTensor laid out as its parameter, less the dim it
    averages over (``_stat_placements``); the update runs on each rank's
    local shards, and each mean over a dim that mesh dims split (the two
    statistics', the row factor's, the update clip's RMS over the whole
    group) sums the local sums over their groups.  On one device the
    arithmetic is as it was: the same ops in the same order."""

    def init(params):
        from repro_torch.distribution.partitioning import is_dtensor

        state, count = {}, _count_like(tree_leaves(params)[0])
        for name, ts, stacked in leaf_groups(params):
            leaf = ts[0]
            shape = ((len(ts),) if stacked else ()) + tuple(leaf.shape)
            local = tuple(_local(leaf).shape)
            local = ((len(ts),) if stacked else ()) + local
            dev = _local(leaf).device

            def z(keep, place):
                t = torch.zeros(tuple(local[i] for i in keep),
                                dtype=torch.float32, device=dev)
                if not is_dtensor(leaf):
                    return t
                from torch.distributed.tensor import DTensor

                return DTensor.from_local(t, leaf.device_mesh, place,
                                          run_check=False)

            n = len(shape)
            if n >= 2:
                pr, pc = ((None, None) if not is_dtensor(leaf) else
                          _stat_placements(leaf.placements, n, stacked))
                state[name] = {"vr": z(range(n - 1), pr),
                               "vc": z([*range(n - 2), n - 1], pc)}
            else:
                state[name] = {"v": z(range(n), None if not is_dtensor(leaf)
                                      else list(leaf.placements))}
        return {"v": state, "count": count}

    def update(grads, state, params, lr):
        count = _local(state["count"])
        count.add_(1)
        beta = 1.0 - count.float() ** (-cfg.decay)
        with torch.no_grad():
            for (name, gs, stacked), (_, ps, _) in zip(leaf_groups(grads),
                                                       leaf_groups(params)):
                v = {k: _local(t) for k, t in state["v"][name].items()}
                split = _Split.of(ps[0], len(ps), stacked)
                lg = [_local(g, p) for g, p in zip(gs, ps)]
                lp = [_local(p) for p in ps]
                g32 = (torch.stack(lg) if stacked else lg[0]).float()
                p32 = (torch.stack(lp) if stacked else lp[0]).float()
                g2 = torch.square(g32) + cfg.eps
                n = p32.ndim
                if n >= 2:
                    vr = beta * v["vr"] + (1 - beta) * split.mean(
                        g2, -1, n - 1)
                    vc = beta * v["vc"] + (1 - beta) * split.mean(
                        g2, -2, n - 2)
                    rfac = torch.rsqrt(vr / split.mean(vr, -1, n - 2,
                                                       keepdim=True)
                                       + cfg.eps)
                    cfac = torch.rsqrt(vc + cfg.eps)
                    step = g32 * rfac[..., None] * cfac[..., None, :]
                    v["vr"].copy_(vr)
                    v["vc"].copy_(vc)
                else:
                    vv = beta * v["v"] + (1 - beta) * g2
                    step = g32 * torch.rsqrt(vv + cfg.eps)
                    v["v"].copy_(vv)
                # update clipping (rms of the step <= threshold), over the
                # whole stacked group as over the reference's stacked leaf
                rms = torch.sqrt(split.mean_all(torch.square(step)) + 1e-30)
                step = step / torch.clamp(rms / cfg.clip_threshold, min=1.0)
                if cfg.weight_decay and n >= 2:
                    step = step + cfg.weight_decay * p32
                newp = p32 - lr * step
                for i, p in enumerate(lp):
                    p.copy_(newp[i] if stacked else newp)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    """step -> lr: linear warmup from 0, then a cosine down to
    ``final_frac * base_lr`` at ``total``.  0 at step 0."""
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * min(1.0, step / max(warmup, 1))
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + math.cos(math.pi * prog)))

    return lr


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name == "adamw":
        return adamw(AdamWConfig(**kwargs))
    if name == "adafactor":
        return adafactor(AdafactorConfig(**kwargs))
    raise ValueError(name)
