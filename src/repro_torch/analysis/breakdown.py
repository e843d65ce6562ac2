"""Where a step's work goes (the counterpart of
``src/repro/analysis/breakdown.py``), in two halves.

Counted, on any machine: ``report(cost, top)`` reads an
``opcount.Cost`` of a step traced on ``meta`` tensors and gives the top
modules (the port's function that dispatched each operation, or a
backward operation's autograd node) and operation classes by FLOPs and by
bytes, with the totals, as the reference's ``report`` gives its top
computations and per-op bytes.

  PYTHONPATH=src python -m repro_torch.analysis.breakdown --arch X \\
      --cell Y [--top 12] [--reduced]

Measured, on the card: ``profile_step(run)`` profiles one call of
``run`` and splits its device time by kernel class: the port's kernels
and cuBLAS by kernel name, and every other kernel ("other") by the aten
operation that launched it (the profiler's CPU-op -> kernel correlation)
and the port's function that called that operation (``with_stack``): the
norms, RoPE, the cross-entropy, softmax, the optimizer's passes, gradient
clipping, MoE routing and dispatch, the Mamba block's glue, casts and
copies, gathers, and the remaining elementwise operations.  A backward
kernel takes the class of the forward operation whose autograd node
launched it (the two share a sequence number).  The classes sum to the
device total, and the busy share is the union of the kernels' intervals
over the step's wall.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

# the port's kernels and cuBLAS, by kernel name (lower case, substrings);
# the backward's kernels, its split fold included, carry the flash_bwd
# prefix
KERNEL_CLASSES = (
    ("flash backward", ("flash_bwd",)),
    ("flash forward", ("flash_attention_mma", "flash_attention_simt")),
    ("ragged decode", ("ragged_decode",)),
    ("scan backward", ("mamba_scan_bwd",)),
    ("scan forward", ("mamba_scan_kernel",)),
    ("mamba step", ("mamba_step",)),
    ("filco_mm", ("filco_mm",)),
    ("matmul (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
)
OTHER = "other"
# "other" by the port's function on the launching operation's stack,
# innermost first: (class, file, functions or None for any in the file)
FUNCTION_CLASSES = (
    ("norm", "models/layers.py", ("rms_norm", "layer_norm", "apply_norm")),
    ("RoPE", "models/layers.py", ("apply_rope", "rope_freqs")),
    ("cross-entropy", "models/transformer.py",
     ("_xent_chunk", "chunked_softmax_xent")),
    ("gradient clip", "optim/base.py", ("global_norm", "clip_by_global_norm")),
    ("optimizer (AdamW, Adafactor)", "optim/base.py", None),
    ("MoE routing and dispatch", "models/moe.py",
     ("_routing", "_capacity_positions", "_one_hot", "moe_apply")),
    ("Mamba glue (conv, gates)", "models/ssm.py", None),
    ("attention, plain path", "models/layers.py",
     ("_flash_fwd_pass", "_flash_bwd_pass", "blockwise_attention",
      "decode_attention")),
)
# then by the aten operation's name (substrings)
OP_CLASSES = (
    ("softmax", ("softmax",)),
    ("casts and copies", ("_to_copy", "copy_", "clone", "contiguous")),
    ("gathers and scatters", ("embedding", "index", "gather", "scatter")),
)
ELEMENTWISE = "elementwise and other"
UNLINKED = "no launching operation"      # a kernel the profiler linked to none
_BACKWARD = "autograd::engine::evaluate_function: "


def kernel_class(name: str) -> Optional[str]:
    """The class of a kernel by its name, None for "other"."""
    low = name.lower()
    return next((k for k, pats in KERNEL_CLASSES
                 if any(p in low for p in pats)), None)


def stack_class(stack: Iterable[str]) -> Optional[str]:
    """The class of the innermost port function on ``stack`` (profiler
    frames "path(line): function", innermost first) that names one."""
    for frame in stack:
        if "repro_torch/" not in frame:
            continue
        path, _, fn = frame.partition(": ")
        for cls, file, fns in FUNCTION_CLASSES:
            if file in path and (fns is None or fn in fns):
                return cls
    return None


def op_name_class(name: str) -> str:
    low = name.lower()
    return next((k for k, pats in OP_CLASSES if any(p in low for p in pats)),
                ELEMENTWISE)


class _Classifier:
    """Classes CPU operations of one profile: by their own stack or their
    parents', and a backward operation by the forward operation of its
    autograd node's sequence number."""

    def __init__(self, cpu_events: List):
        self._by_seq: Dict[int, str] = {}
        for e in cpu_events:
            seq = getattr(e, "sequence_nr", -1)
            if seq >= 0 and seq not in self._by_seq and \
                    not e.name.startswith(_BACKWARD):
                cls = self._own(e)
                if cls is not None:
                    self._by_seq[seq] = cls

    @staticmethod
    def _own(e) -> Optional[str]:
        """By the port's functions above ``e``: the profiler's Python
        function events among its parents (or a recorded stack)."""
        while e is not None:
            cls = stack_class(e.stack or (e.name,))
            if cls is not None:
                return cls
            e = e.cpu_parent
        return None

    def __call__(self, op) -> str:
        """By the innermost port function above ``op``; met first, a
        backward node classes it by its forward operation (a remat
        recompute inside a backward node has its own functions)."""
        if op is None:
            return UNLINKED
        e = op
        while e is not None:
            if e.name.startswith(_BACKWARD):
                if "AccumulateGrad" in e.name:
                    return "gradient accumulation"
                cls = self._by_seq.get(e.sequence_nr)
                return cls or op_name_class(op.name)
            cls = stack_class(e.stack or (e.name,))
            if cls is not None:
                return cls
            e = e.cpu_parent
        return op_name_class(op.name)


def split_profile(events, *, wall_s: float = None):
    """Device time of one profiled step by class.  ``events``: the
    profiler's ``FunctionEvent`` list.  The card's kernels (CUDA events)
    are classed by name, and "other" by the operation each was launched
    from (the CPU operation whose ``kernels`` lists it: the profiler's
    correlation); what no operation lists (a kernel launched outside any
    aten operation) is ``UNLINKED``.  Returns {"device_ms" (the kernels'
    summed time), "busy_ms", "busy_share" (None without ``wall_s``),
    "classes": {class: ms} with "other" among them, "other": {class:
    ms}}."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    classify = _Classifier(cpu)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in events if e.device_type == DeviceType.CUDA]
    # the profiler's markers inside an op ("Command Buffer Full") carry its
    # correlation id and list its kernels again: one event an id, the
    # earliest (the op itself)
    owners = {}
    for e in cpu:
        if getattr(e, "kernels", None) and (
                e.id not in owners
                or e.time_range.start < owners[e.id].time_range.start):
            owners[e.id] = e
    classes = {k: 0.0 for k, _ in KERNEL_CLASSES}
    classes[OTHER] = 0.0
    for name, a, b in spans:
        classes[kernel_class(name) or OTHER] += (b - a) / 1e3
    other: Dict[str, float] = {}
    for e in owners.values():
        for k in e.kernels:
            if kernel_class(k.name) is None:
                sub = classify(e)
                other[sub] = other.get(sub, 0.0) + k.duration / 1e3
    rest = classes[OTHER] - sum(other.values())
    if rest > 1e-6:
        other[UNLINKED] = other.get(UNLINKED, 0.0) + rest
    union, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda t: t[1]):
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_ms = union / 1e3
    total = sum(b - a for _, a, b in spans) / 1e3
    return {"device_ms": total, "busy_ms": busy_ms,
            "busy_share": busy_ms / (wall_s * 1e3) if wall_s else None,
            "classes": classes,
            "other": dict(sorted(other.items(), key=lambda kv: -kv[1]))}


def profile_step(run: Callable[[], object], *, wall_s: float = None,
                 stacks: bool = True) -> Optional[dict]:
    """Profile one call of ``run`` (its operations and the card's kernels)
    and return ``split_profile`` of it; None where the profiler recorded
    no device time.  ``stacks``: keep each operation's Python stack, so
    that "other" splits by the port's functions (else by the operations'
    names alone; a host-bound step profiles much faster)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # verbose: each operation keeps its Python stack (without it some
    # versions record none)
    config = torch._C._profiler._ExperimentalConfig(verbose=stacks)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=stacks, experimental_config=config) as prof:
        run()
        torch.cuda.synchronize()
    out = split_profile(prof.events(), wall_s=wall_s)
    return out if out["device_ms"] > 0 else None


def format_split(split: dict) -> str:
    """One line of a ``split_profile`` result."""
    share = ("not measured" if split["busy_share"] is None
             else f"{split['busy_share']:.3f}")
    return (f"device {split['device_ms']:.1f} ms, busy {split['busy_ms']:.1f} "
            f"ms (share {share}); by class (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in split["classes"].items()
                        if v)
            + "; other by class (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in split["other"].items()))


# ---------------------------------------------------------------------------
# the counted half
# ---------------------------------------------------------------------------

def _top(table: Dict[str, List[float]], col: int, top: int):
    return sorted(table.items(), key=lambda kv: -kv[1][col])[:top]


def report(cost, top: int = 12) -> str:
    """Top modules and operation classes of ``cost`` (an ``opcount.Cost``
    counted with modules) by FLOPs and by bytes, then the totals."""
    out = []
    for title, table in (("module", cost.by_module), ("op", cost.by_op)):
        for col, unit, scale in ((1, "TFLOP", 1e12), (2, "TB", 1e12)):
            out.append(f"{'calls':>8s} {unit:>10s}  {title} by {unit}")
            for key, row in _top(table, col, top):
                out.append(f"{int(row[0]):8d} {row[col] / scale:10.4f}  "
                           f"{key[:70]}")
            out.append("")
    if cost.kernels:
        out.append("kernels (launches, TFLOP, TB):")
        for key, row in _top(cost.kernels, 1, top):
            out.append(f"  {key:28s} {int(row[0]):6d} {row[1] / 1e12:10.4f} "
                       f"{row[2] / 1e12:9.4f}")
        out.append("")
    out.append(f"totals/device: flops={cost.flops:.3e} "
               f"bytes={cost.bytes / 1e12:.3f}TB "
               f"peak={cost.peak_bytes / 2**30:.2f}GiB "
               f"collective={cost.collective_bytes / 1e9:.1f}GB "
               f"{cost.collective_by_kind}")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse

    from repro_torch.analysis import opcount
    from repro_torch.configs import (ARCH_IDS, CELLS_BY_NAME, get_config,
                                     get_reduced)
    from repro_torch.launch.dryrun import build_cell

    ap = argparse.ArgumentParser(description="counted breakdown of one "
                                 "arch x cell step on meta tensors")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--cell", choices=sorted(CELLS_BY_NAME), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    step, live = build_cell(cfg, CELLS_BY_NAME[args.cell])
    _, cost = opcount.count(step, live=live)
    print(report(cost, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
