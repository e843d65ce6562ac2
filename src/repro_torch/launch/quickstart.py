"""Quickstart of the port: the three faces of the framework, as the
reference's ``examples/quickstart.py``.

 1. FILCO DSE: two-stage search (mode tables -> GA schedule) for a BERT
    workload on the VCK190 profile, -> instruction streams (Table 1).
 2. Training: a reduced assigned-architecture config, a few steps with the
    trainer (checkpoints included).
 3. Serving: the continuous-batching engine on the same model.

    python -m repro_torch.launch.quickstart [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.paper_workloads import bert
from repro_torch.core.analytical import filco_vck190
from repro_torch.core.codegen import generate
from repro_torch.core.dse import run_dse
from repro_torch.core.ga import GAConfig
from repro_torch.data import make_pipeline
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.workloads import DecodeEngine, ServeConfig


def demo_dse():
    print("=== 1. FILCO two-stage DSE (paper §3) ===")
    wl = bert(64, layers=1)
    res = run_dse(wl, filco_vck190(), solver="ga", max_modes=6,
                  ga_config=GAConfig(population=16, generations=20, seed=0))
    print(f"workload: {wl.name} ({len(wl.layers)} MM layers, "
          f"{wl.total_flops / 1e9:.2f} GFLOP)")
    print(f"schedule: makespan={res.makespan * 1e6:.0f}us "
          f"throughput={res.plan.throughput_flops(wl.total_flops) / 1e9:.1f}"
          f" GFLOP/s (stage1={res.stage1_s:.2f}s stage2={res.stage2_s:.2f}s)")
    prog = generate(wl, res.plan)
    print(f"codegen: {len(prog.iom_load)} IOM loads, "
          f"{sum(len(s) for s in prog.fmu.values())} FMU instrs, "
          f"{sum(len(s) for s in prog.cu.values())} CU instrs, "
          f"{prog.total_bytes()} bytes total "
          f"(runtime reconfiguration = a few bytes/layer, no bitstream "
          f"reload)")


def demo_train(device):
    print("\n=== 2. Training (reduced qwen2.5 config) ===")
    cfg = get_reduced("qwen2.5-32b")
    model = build_model(cfg, device)
    pipe = make_pipeline(cfg, seq_len=32, global_batch=4)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model, TrainConfig(steps=6, lr=1e-3, warmup=2,
                                        log_every=2, checkpoint_every=6,
                                        ckpt_dir=d),
                     pipeline=pipe, device=device)
        out = tr.fit()
    losses = [m["loss"] for m in out["metrics"]]
    print(f"status={out['status']} losses={['%.3f' % l for l in losses]}")
    assert out["status"] == "completed" and all(np.isfinite(losses)), losses


def demo_serve(device):
    print("\n=== 3. Serving (continuous batching + FlexArena KV pool) ===")
    cfg = get_reduced("qwen2.5-32b")
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = DecodeEngine(model, params,
                       ServeConfig(max_slots=3, max_len=48, eos_id=-1,
                                   prefill_bucket=8))
    rng = np.random.default_rng(0)
    rids = [eng.submit(rng.integers(1, cfg.vocab_size, size=n),
                       max_new_tokens=6) for n in (5, 11, 7)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
    res = eng.results()
    assert all(len(res[r]) == 6 for r in rids), res
    print(f"served 3 requests in {steps} decode steps; "
          f"arena utilization now {eng.arena.utilization():.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    demo_dse()
    demo_train(args.device)
    demo_serve(args.device)
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
