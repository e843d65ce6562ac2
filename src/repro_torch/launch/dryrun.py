"""Dry run on one H100: for every (architecture x shape cell), trace the
real train, prefill or decode step on ``meta`` tensors, count its FLOPs,
bytes and peak footprint (``repro_torch.analysis.opcount``) and derive the
roofline terms on ``H100_SXM`` (``repro_torch.analysis.roofline``); the
counterpart of ``src/repro/launch/dryrun.py``, on one card with no mesh.
Nothing is allocated, so every registered arch counts at full width,
arctic-480b's ``train_4k`` (B 256 x S 4096) included.  Results cache as
one JSON per cell under ``--out`` so the grid resumes; a failed cell
leaves ``<tag>.FAILED`` with its traceback.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b \\
      --cell train_4k [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 32 cells

The step is the one the card runs: the kernel path (``use_kernels``), the
flash, ragged decode and scan kernels counted by their bounds' formulas.
``train``: ``Model.loss`` under per-layer remat, its backward, global-norm
clipping and AdamW (``make_train_step``), the masters in the config's
``param_dtype`` (fp32; arctic-480b's bf16) and AdamW's moments in fp32
(every train cell at AdamW's state, the optimizer ``PERF.md`` §2's
training limit is set for, where qwen1.5-110b and arctic-480b name
Adafactor); ``prefill``: ``Model.prefill`` into an
``init_cache(B, S)`` cache with bf16 inference weights; ``decode``: one
``Model.decode_step`` against an S-long cache (enc-dec: a source of
``ENCDEC_DECODE_SRC``).  ``fits_hbm`` holds the peak to ``FIT_BYTES``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Callable, Tuple, Union

import torch

from repro_torch.analysis import opcount
from repro_torch.analysis import roofline as roof
from repro_torch.configs import ARCH_IDS, CELLS_BY_NAME, cells_for, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell

ENCDEC_DECODE_SRC = 4096
# PERF.md §2's peak-memory limit for training on one 80 GB card: 78 GiB
# (H100_SXM.hbm_bytes, 80e9 B = 74.5 GiB, prices the fabric's policy)
FIT_BYTES = 78 * 2**30
_DEV = "meta"
# the reference's knobs that have no meaning on one card, and why
_REFUSED = {
    "multi_pod": "--multi-pod: the meshes wait for a second GPU "
                 "(ROADMAP queue 1 item 7)",
    "no_sp": "--no-sp: sequence parallelism needs a mesh, which waits for "
             "a second GPU (ROADMAP queue 1 item 7)",
    "moe_group": "--moe-group: the group size shards the dispatch over a "
                 "mesh, which waits for a second GPU (ROADMAP queue 1 "
                 "item 7)",
    "attn_impl": "--attn-impl triangular: the flash kernel already skips "
                 "the masked blocks",
    "ssm_impl": "--ssm-impl: the port has one scan (the kernel)",
    "attn_block": "--attn-block: the flash kernel's tiles are its own",
}


def _batch(cfg: ModelConfig, cell: ShapeCell, B: int, S: int):
    """The step's inputs on ``meta``: tokens (and labels) (B, S) int32,
    frames (B, S, d) in the activation dtype for a frames frontend."""
    i32 = dict(dtype=torch.int32, device=_DEV)
    out = {"tokens": torch.zeros((B, S), **i32)}
    if cell.kind == "train":
        out["labels"] = torch.zeros((B, S), **i32)
    if cfg.is_encdec and cfg.frontend == "frames":
        out["frames"] = torch.zeros((B, S, cfg.d_model),
                                    dtype=cfg.activation_dtype, device=_DEV)
    return out


def build_cell(cfg: ModelConfig, cell: ShapeCell, *,
               moe_dispatch: str = "einsum",
               remat: bool = True) -> Tuple[Callable[[], object], tuple]:
    """(step, live): ``step()`` runs the cell's step once on ``meta``
    tensors; ``live`` holds what is alive before it (weights, optimizer
    state, cache, inputs), for the footprint."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainConfig, make_train_step

    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        cfg = dataclasses.replace(cfg, remat=remat)
        model = build_model(cfg, _DEV)
        if moe_dispatch != "einsum":
            model.loss = functools.partial(type(model).loss, model,
                                           moe_dispatch=moe_dispatch)
        params = model.init(None, dtype=cfg.param_dtype)
        opt = make_optimizer("adamw")
        state = opt.init(params)
        batch = _batch(cfg, cell, B, S)
        step_fn = make_train_step(model, opt, TrainConfig())
        return (lambda: step_fn(params, state, 1, batch),
                (params, state, batch))

    model = build_model(cfg, _DEV)
    params = model.init(None)           # bf16 inference weights
    if cell.kind == "prefill":
        cache = model.init_cache(B, S, src_len=S if cfg.is_encdec else 0)
        batch = _batch(cfg, cell, B, S)
        return (lambda: model.prefill(params, batch, cache, use_kernels=True,
                                      moe_dispatch=moe_dispatch),
                (params, cache, batch))
    if cell.kind != "decode":
        raise ValueError(cell.kind)
    cache = model.init_cache(
        B, S, src_len=ENCDEC_DECODE_SRC if cfg.is_encdec else 0)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=_DEV)
    return (lambda: model.decode_step(params, cache, tokens, use_kernels=True,
                                      moe_dispatch=moe_dispatch),
            (params, cache, tokens))


def run_cell(arch: str, cell: Union[str, ShapeCell], *,
             moe_dispatch: str = "einsum", remat: bool = True,
             variant: str = "baseline", cfg: ModelConfig = None) -> dict:
    """Count one cell's step and derive its terms.  ``cell``: a name of
    ``CELLS_BY_NAME`` or any ``ShapeCell``; ``cfg`` (default
    ``get_config(arch)``) may be a cut of the arch."""
    cfg = cfg or get_config(arch)
    if isinstance(cell, str):
        cell = CELLS_BY_NAME[cell]
    t0 = time.monotonic()
    step, live = build_cell(cfg, cell, moe_dispatch=moe_dispatch,
                            remat=remat)
    _, cost = opcount.count(step, live=live, modules=False)
    del step, live
    trace_s = time.monotonic() - t0
    peak = cost.peak_bytes
    terms = roof.derive_terms(
        arch=arch, cell=cell.name, mesh_name="single", chips=1,
        cost={"flops": cost.flops, "bytes accessed": cost.bytes},
        collective=roof.CollectiveStats(), model_flops=roof.model_flops_for(
            cfg, cell), peak_memory_bytes=peak)
    return {
        "arch": arch, "cell": cell.name, "mesh": "single", "chips": 1,
        "variant": variant, "kind": cell.kind,
        "global_batch": cell.global_batch, "seq_len": cell.seq_len,
        "moe_dispatch": moe_dispatch, "remat": remat,
        "trace_s": round(trace_s, 2),
        "peak_bytes_per_device": peak,
        "fits_hbm": peak <= FIT_BYTES,
        "hlo_flops_per_device": cost.flops,
        "hlo_bytes_per_device": cost.bytes,
        "collective_bytes_per_device": 0.0,
        "collective_by_kind": {},
        "collective_count": {},
        "kernels": cost.kernels,
        "roofline": terms.row(),
    }


def cell_list():
    """Every (arch, cell name) of the grid: 10 archs x ``cells_for``."""
    return [(arch, cell.name) for arch in ARCH_IDS
            for cell in cells_for(get_config(arch))]


def summary(res: dict) -> str:
    """One log line: peak GiB, fit, compute and memory ms, dominant."""
    r = res["roofline"]
    return (f"peak={res['peak_bytes_per_device'] / 2**30:.2f}GiB "
            f"fits={res['fits_hbm']} compute={r['compute_s'] * 1e3:.3f}ms "
            f"memory={r['memory_s'] * 1e3:.3f}ms dominant={r['dominant']} "
            f"roofline={r['roofline_fraction']:.3f} "
            f"trace={res['trace_s']}s")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--cell", choices=sorted(CELLS_BY_NAME))
    ap.add_argument("--all", action="store_true",
                    help="every runnable cell of every arch (in process)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "gather"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    # the reference's, refused with their reason (_REFUSED)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--moe-group", type=int, default=-1)
    ap.add_argument("--attn-impl", default="blockwise",
                    choices=["blockwise", "triangular"])
    ap.add_argument("--ssm-impl", default=None,
                    choices=["chunked", "fused", "fused_serial"])
    ap.add_argument("--attn-block", type=int, default=None)
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    asked = {"multi_pod": args.multi_pod, "no_sp": args.no_sp,
             "moe_group": args.moe_group >= 0,
             "attn_impl": args.attn_impl == "triangular",
             "ssm_impl": args.ssm_impl is not None,
             "attn_block": args.attn_block is not None}
    for key, on in asked.items():
        if on:
            ap.error(_REFUSED[key])
    if args.all:
        todo = cell_list()
    elif args.arch and args.cell:
        todo = [(args.arch, args.cell)]
    else:
        ap.error("--arch and --cell (or --all)")
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, cell in todo:
        tag = f"{arch}__{cell}__single__{args.variant}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[run ] {tag}", flush=True)
        try:
            res = run_cell(arch, cell, moe_dispatch=args.moe_dispatch,
                           remat=not args.no_remat, variant=args.variant)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"[ok  ] {tag}: {summary(res)}", flush=True)
        except Exception as e:  # noqa: BLE001 — record, continue the grid
            failures.append((tag, repr(e)))
            with open(os.path.join(args.out, tag + ".FAILED"), "w") as f:
                f.write(traceback.format_exc())
            print(f"[FAIL] {tag}: {e!r}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        return 1
    print("\nall cells OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
