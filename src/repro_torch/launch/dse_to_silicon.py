"""The paper's pipeline on one workload, on the port's data plane.

    python -m repro_torch.launch.dse_to_silicon [--workload BERT-128] \\
        [--device cpu]

DNN as an MM-layer DAG -> two-stage DSE (Stage 1 mode tables, Stage 2 GA
schedule) -> Table-1 instruction streams -> functional execution on
``DataPlaneSim``, every CU pass through the ``flex_mm`` kernel on a CUDA
device -> every layer's result region in DDR checked against a plain fp32
walk of the DAG with ``torch.matmul`` (TF32 off), within ``REL_TOL`` of the
layer's largest |value|.  The counterpart of ``examples/dse_to_silicon.py``,
with its settings.  Prints JSON; exits 1 on a mismatch.  Runs
on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.paper_workloads import (PAPER_WORKLOADS, MMWorkload,
                                                 bert)
from repro_torch.core.analytical import filco_vck190
from repro_torch.core.codegen import DDRLayout, Program, generate
from repro_torch.core.dse import DSEResult, run_dse
from repro_torch.core.ga import GAConfig
from repro_torch.core.simulator import DataPlaneSim, cu_pass_dims
from repro_torch.device import DeviceLike, resolve_device

# the example's workload, beside the paper's
WORKLOADS: Dict[str, MMWorkload] = dict(
    PAPER_WORKLOADS, **{"BERT-32/L1": bert(32, layers=1, name="BERT-32/L1")})
# fp32 data plane against an fp32 walk: summation order only, relative to
# each layer's largest |value|
REL_TOL = 1e-4
# examples/dse_to_silicon.py's settings: DSE, and the numpy seed of the
# input and weights
MAX_MODES = 6
GA_CONFIG = GAConfig(population=24, generations=30, seed=0)
SEED = 0


def ddr_image(wl: MMWorkload, layout: DDRLayout, seed: int) -> np.ndarray:
    """The DDR image the example loads: the input, then each layer's
    weight scaled by 1/sqrt(k), drawn from ``default_rng(seed)`` in that
    order; fp32, ``layout.total_elems`` elements."""
    rng = np.random.default_rng(seed)
    image = np.zeros(layout.total_elems, np.float32)
    first = wl.layers[0]
    x0 = rng.normal(size=(first.m, first.k)).astype(np.float32)
    image[layout.input_addr:layout.input_addr + x0.size] = x0.reshape(-1)
    for i, l in enumerate(wl.layers):
        w = (rng.normal(size=(l.k, l.n)) / np.sqrt(l.k)).astype(np.float32)
        image[layout.weight_addr[i]:layout.weight_addr[i] + w.size] = \
            w.reshape(-1)
    return image


def reference_walk(wl: MMWorkload, layout: DDRLayout,
                   ddr0: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Each layer's result by a plain fp32 walk of the DAG over the pre-run
    DDR image, with codegen's operand provenance: the first dependency
    whose (m, n) is this layer's (m, k), else an (m, k) read at the input
    region."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for i, l in enumerate(wl.layers):
            src = next((outs[d] for d in l.deps
                        if (wl.layers[d].m, wl.layers[d].n) == (l.m, l.k)),
                       None)
            if src is None:
                a = layout.input_addr
                src = ddr0[a:a + l.m * l.k].view(l.m, l.k)
            w = layout.weight_addr[i]
            outs[i] = torch.matmul(src, ddr0[w:w + l.k * l.n].view(l.k, l.n))
        return outs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def layer_errors(wl: MMWorkload, layout: DDRLayout, ddr: torch.Tensor,
                 outs: Dict[int, torch.Tensor]) -> np.ndarray:
    """max |DDR result - walk| / max |walk| of every layer, read back in
    one transfer."""
    errs = []
    for i, l in enumerate(wl.layers):
        a = layout.result_addr[i]
        got = ddr[a:a + l.m * l.n].view(l.m, l.n)
        errs.append((got - outs[i]).abs().max()
                    / outs[i].abs().max().clamp_min(1e-30))
    return torch.stack(errs).cpu().numpy()


@dataclasses.dataclass
class PathRun:
    dse: DSEResult
    prog: Program
    sim: DataPlaneSim
    errors: np.ndarray                   # per layer, relative
    stats: dict


def run_path(wl: MMWorkload, *, device: DeviceLike = None) -> PathRun:
    """Workload -> ``run_dse`` -> ``generate`` -> ``DataPlaneSim.run`` ->
    the reference walk, with the example's DSE settings and DDR image,
    timing each stage on the host clock (the device is synchronised before
    the simulator's time is read)."""
    dev = resolve_device(device)
    accel = filco_vck190()
    t0 = time.perf_counter()
    res = run_dse(wl, accel, solver="ga", max_modes=MAX_MODES,
                  ga_config=GA_CONFIG)
    t1 = time.perf_counter()
    prog = generate(wl, res.plan)
    t2 = time.perf_counter()
    layout = prog.layout
    # each FMU holds the largest operand (the real FMU streams tiles;
    # numerics are identical)
    fmu_cap = max(max(l.m * l.k, l.k * l.n, l.m * l.n) for l in wl.layers)
    sim = DataPlaneSim(layout.total_elems, accel.num_fmus, fmu_cap,
                       accel.num_cus, device=dev)
    sim.ddr.copy_(torch.from_numpy(ddr_image(wl, layout, SEED)))
    ddr0 = sim.ddr.clone()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    sim.run(prog)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    outs = reference_walk(wl, layout, ddr0)
    errors = layer_errors(wl, layout, sim.ddr, outs)
    dims = cu_pass_dims(prog)
    stats = {
        "workload": wl.name, "device": str(dev), "layers": len(wl.layers),
        "cu_passes": len(dims), "pass_shapes": len(set(dims)),
        "instr_bytes": prog.total_bytes(), "ddr_elems": layout.total_elems,
        "fmus": accel.num_fmus, "fmu_elems": fmu_cap,
        "makespan_s": res.makespan,
        "dse_s": t1 - t0, "codegen_s": t2 - t1, "sim_s": t4 - t3,
        "max_rel_err": float(errors.max()), "rel_tol": REL_TOL,
        "ok": bool(np.all(np.isfinite(errors)) and errors.max() <= REL_TOL),
    }
    return PathRun(res, prog, sim, errors, stats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS),
                    default="BERT-32/L1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run = run_path(WORKLOADS[args.workload], device=args.device)
    print(json.dumps(run.stats))
    return 0 if run.stats["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
