"""Single-tenant serving launcher of the port.

    python -m repro_torch.launch.serve --arch minitron-4b [--reduced] \\
        [--device cpu] --requests N

Builds the model with random weights from ``--seed``, warms the engine's
decode steps (``warm_compile``: CUDA graphs on the card) before the clock,
submits ``N`` requests with random prompts, runs the engine of the arch's
workload class until they finish (``DecodeEngine`` for dense archs,
``SSMEngine`` for ``falcon-mamba-7b``) and prints JSON stats, as
``repro.launch.serve`` does in single-model mode.  Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models.model import build_model
from repro_torch.workloads import (DECODE, SSM, DecodeEngine, SSMEngine,
                                   ServeConfig, workload_class_of)

ENGINES = {DECODE: DecodeEngine, SSM: SSMEngine}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    engine = ENGINES[workload_class_of(cfg)](
        model, params, ServeConfig(max_slots=args.max_slots,
                                   max_len=args.max_len, eos_id=-1))
    warm_builds = engine.warm_compile(None)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, size=plen)
        engine.submit(prompt, max_new_tokens=args.max_new_tokens)
    steps = emitted = 0
    step_ms = []
    while engine.has_work and steps <= 10_000:
        s0 = time.perf_counter()
        emitted += len(engine.step())
        step_ms.append((time.perf_counter() - s0) * 1e3)
        steps += 1
    dt = time.monotonic() - t0
    arr = np.asarray(step_ms)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
        "arch": cfg.name, "workload_class": engine.workload_class,
        "requests": args.requests, "decode_steps": steps,
        "tokens_emitted": emitted, "wall_s": round(dt, 2),
        "tokens_per_s": round(emitted / dt, 1),
        "step_ms": {"p50": round(float(np.percentile(arr, 50)), 2),
                    "p95": round(float(np.percentile(arr, 95)), 2)},
        "arena_utilization": engine.arena.utilization(),
        "warm_compile_builds": warm_builds,
        "graph_captures": engine.graph_captures,
        "covering_steps": engine.covering_steps,
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
