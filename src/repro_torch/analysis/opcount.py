"""FLOP, byte and footprint counts of a step, traced on ``meta`` tensors
(the counterpart of ``src/repro/analysis/hlo.py``).

The reference parses a compiled XLA program.  The port runs eagerly, so it
counts the operations as they are dispatched: ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten operation of a step, forward,
remat recompute and backward alike, and each hand-written kernel reports
its own work where its wrapper meets ``meta`` tensors (``kernel``).  On
``meta`` tensors nothing is allocated and no data exists, so a full-width
step of any registered arch is counted on any machine.

Per operation:

  flops  -- the products, by ``torch.utils.flop_counter``'s formulas (mm,
            bmm, addmm, baddbmm, convolution: the einsums lower to them);
            each kernel by the formula of its bound
            (``repro_torch.analysis.roofline``: attended pairs for flash,
            the rows read for ragged decode, the scan's work).
  bytes  -- each aten operation that is not a view reads its tensor
            operands and writes its results: the eager counterpart of the
            reference's fusion-boundary model, where each eager operation
            is one kernel that reads and writes HBM.  Views, ``empty*``,
            ``detach`` and the other metadata operations count 0, as the
            reference's bitcast, tuple and parameter do; ``copy_``,
            ``fill_`` and ``zero_`` do not read what they overwrite; a
            gather (indexing, ``embedding``, ``index_select``) reads what it
            writes, as the reference's gather counts twice its result.
            Each kernel counts the bytes its bound counts.
  peak   -- the largest sum of live storages over the step: every storage
            an operation makes or meets is counted from then until it is
            freed (a ``weakref.finalize`` on the storage), and the tensors
            handed in as ``live`` (parameters, optimizer state, caches)
            from the start.

``Cost`` keeps the reference's field names (``flops``, ``bytes``,
``collective_bytes`` at 0, ``collective_by_kind`` and ``collective_count``
empty on one card) and adds ``peak_bytes`` and the counts by operation, by
module (the innermost function of the port that dispatched it, or the
autograd node of a backward operation) and by kernel.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_PKG = str(Path(__file__).resolve().parents[1]) + "/"
_SKIP = (_PKG + "analysis/", _PKG + "kernels/")
_aten = torch.ops.aten
# metadata operations: no data moves
_FREE = {p for p in (
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.lift_fresh, _aten.alias,
    _aten._unsafe_view, _aten.set_, _aten.resize_, _aten.sym_size,
    _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset,
    _aten.is_same_size, _aten.resolve_conj, _aten.resolve_neg)}
# write their first operand without reading it
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}
# read what they write (and their indices), not the whole source
_GATHER = {_aten.index, _aten.embedding, _aten.index_select, _aten.gather}

_ACTIVE: List["OpCounter"] = []


def _table():
    return dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = _table()
    collective_count: Dict[str, int] = _table()
    peak_bytes: float = 0.0
    # op class -> [calls, flops, bytes]; kernels as "kernel:<name>"
    by_op: Dict[str, List[float]] = _table()
    # module -> [calls, flops, bytes]
    by_module: Dict[str, List[float]] = _table()
    # kernel -> [launches, flops, bytes]
    kernels: Dict[str, List[float]] = _table()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _add(table: dict, key: str, calls: float, flops: float, nbytes: float):
    row = table.get(key)
    if row is None:
        table[key] = [calls, flops, nbytes]
    else:
        row[0] += calls
        row[1] += flops
        row[2] += nbytes


def _module() -> str:
    """The innermost frame of the port that dispatched the operation, as
    "package.module.function" (the kernels' wrappers and this package
    skipped: a kernel goes by its caller); a backward operation outside
    the models goes by its autograd node."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PKG) and not name.startswith(_SKIP):
            tag = name[len(_PKG):-3].replace("/", ".") + "." + f.f_code.co_name
            break
        f = f.f_back
    else:
        tag = "(caller)"
    node = torch._C._current_autograd_node()
    if node is not None and not tag.startswith("models."):
        return "backward." + node.name()
    return tag


class OpCounter(TorchDispatchMode):
    """Counts what runs under it into ``self.cost``.  ``live``: tensors (a
    tree) alive before the step that count toward its peak from the start.
    ``modules``: attribute each operation to the function that dispatched
    it (a frame walk per operation)."""

    def __init__(self, live=(), modules: bool = True):
        super().__init__()
        self.cost = Cost()
        self.modules = modules
        self._live = 0
        self._sizes: Dict[int, int] = {}
        self._pending = list(_tensors(live))

    def __enter__(self):
        for t in self._pending:
            self._track(t)
        self._pending = []
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- footprint ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._sizes:
            return
        n = s.nbytes()
        self._sizes[key] = n
        self._live += n
        if self._live > self.cost.peak_bytes:
            self.cost.peak_bytes = float(self._live)
        weakref.finalize(s, self._free, key).atexit = False

    def _free(self, key: int) -> None:
        self._live -= self._sizes.pop(key, 0)

    # -- work --------------------------------------------------------------
    def _charge(self, op: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        _add(c.by_op, op, 1, flops, nbytes)
        if self.modules:
            _add(c.by_module, _module(), 1, flops, nbytes)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        _add(self.cost.kernels, name, 1, flops, nbytes)
        self._charge("kernel:" + name, flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        for t in ins + outs:
            self._track(t)
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return out
        flops = 0
        counter = flop_registry.get(packet)
        if counter is not None:
            flops = counter(*args, **kwargs, out_val=out)
        if not outs and func._schema.is_mutable:
            # in place with no result (the _foreach_*_ ops): what it wrote
            outs = [t for a, v in zip(func._schema.arguments, args)
                    if a.alias_info is not None and a.alias_info.is_write
                    for t in _tensors(v)]
        written = sum(_nbytes(t) for t in outs)
        if packet in _GATHER:
            read = written + sum(_nbytes(t) for t in ins[1:]
                                 if not t.is_floating_point())
        else:
            skip = ins[:1] if packet in _WRITE_ONLY else ()
            read = sum(_nbytes(t) for t in ins
                       if not any(t is s for s in skip))
        self._charge(packet.__name__, flops, read + written)
        return out


def active() -> OpCounter:
    """The innermost active counter; raises outside one."""
    if not _ACTIVE:
        raise RuntimeError(
            "a kernel wrapper met meta tensors outside an OpCounter: meta "
            "tensors carry no data, and only a counter takes their work "
            "(repro_torch.analysis.opcount)")
    return _ACTIVE[-1]


def kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel wrapper's launch on ``meta`` tensors: its work to the
    active counter (raises outside one)."""
    active().kernel(name, flops, nbytes)


def count(fn, *args, live=(), modules: bool = True,
          **kwargs) -> Tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` under a fresh ``OpCounter``: (its result,
    the ``Cost``)."""
    with OpCounter(live=live, modules=modules) as c:
        out = fn(*args, **kwargs)
    return out, c.cost
