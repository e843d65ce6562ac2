"""Serving launcher of the port.

Single tenant:

    python -m repro_torch.launch.serve --arch minitron-4b [--reduced] \\
        [--device cpu] --requests N

builds the model with random weights from ``--seed``, warms the engine's
decode steps (``warm_compile``: CUDA graphs on the card) before the clock,
submits ``N`` requests with random prompts, runs the engine of the arch's
workload class until they finish (``DecodeEngine`` for dense archs,
``SSMEngine`` for ``falcon-mamba-7b``) and prints JSON stats, as
``repro.launch.serve`` does in single-model mode.

Multi-tenant fabric (``--fabric``, one ``--arch`` per tenant):

    python -m repro_torch.launch.serve --fabric --arch minitron-4b \\
        --arch falcon-mamba-7b [--reduced] [--device cpu] [--num-cus 8]

serves the tenants on one card composed of ``--num-cus`` logical CUs
(``ComposedServer``), with the reference launcher's bursty per-tenant
traffic, the two-stage analytical policy (``--split-only`` for the
split-only ablation) deciding every ``--decide-every`` steps, and warm
recomposition (``--no-warm`` off, ``--prewarm-async`` in a background
thread).  Prints one JSON document: the recomposition events, tokens/s
per tenant, the streams digest, the last busy decision's predicted
makespans and the SLO summary.

Both modes run on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.common.platform import H100_SXM, per_cu
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models.model import build_model
from repro_torch.serve import (AnalyticalPolicy, ComposedServer, ServeConfig,
                               TenantSpec)
from repro_torch.workloads import (DECODE, SSM, DecodeEngine, SSMEngine,
                                   workload_class_of)

ENGINES = {DECODE: DecodeEngine, SSM: SSMEngine}


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _streams_digest(results) -> str:
    """Order-independent sha256 over every tenant's (rid -> token stream)
    map: equal digests mean identical serving output."""
    h = hashlib.sha256()
    for t in sorted(results):
        for rid in sorted(results[t]):
            arr = np.asarray(results[t][rid], dtype=np.int64)
            h.update(f"{t}/{rid}:".encode())
            h.update(arr.tobytes())
            h.update(b";")
    return h.hexdigest()


def run_fabric(args) -> int:
    """Traffic-driven multi-tenant serving on one recomposable card."""
    serve = ServeConfig(max_slots=args.max_slots, max_len=args.max_len,
                        eos_id=-1)
    tenants = [TenantSpec(f"tenant{i}-{arch}", arch, reduced=args.reduced,
                          serve=serve, seed=i)
               for i, arch in enumerate(args.arch)]
    policy = AnalyticalPolicy(per_cu(H100_SXM, args.num_cus),
                              two_stage=not args.split_only)
    server = ComposedServer(tenants, num_cus=args.num_cus,
                            device=args.device, policy=policy,
                            decide_every=args.decide_every,
                            warm=not args.no_warm,
                            prewarm_async=args.prewarm_async)
    if not args.no_warm:
        for eng in server.engines.values():
            eng.warm_compile(None)
    rng = np.random.default_rng(args.seed)
    # bursty open-loop traffic, as the reference launcher draws it: an
    # arrival step per request over 4x the per-tenant count, prompt
    # lengths drawn at submit time
    queue = sorted((int(rng.integers(0, 4 * args.requests)), t.name)
                   for t in tenants for _ in range(args.requests))
    t0 = time.monotonic()
    steps = 0
    predicted = None
    while queue or server.pending():
        while queue and queue[0][0] <= steps:
            _, name = queue.pop(0)
            vocab = server.cfgs[name].vocab_size
            plen = int(rng.integers(4, 24))
            server.submit(name, rng.integers(1, vocab, size=plen),
                          max_new_tokens=args.max_new_tokens)
        server.step()
        if policy.predicted is not None:
            predicted = dict(policy.predicted)   # last busy decide's view
        steps += 1
        if steps > 10_000:
            break
    server.drain(max_steps=2000)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    dt = time.monotonic() - t0
    stats = server.stats()
    print(json.dumps({
        "device": _device_name(server.device),
        "tenants": [t.name for t in tenants], "num_cus": args.num_cus,
        "two_stage": not args.split_only, "decode_steps": steps,
        "wall_s": round(dt, 2), **stats,
        "tokens_per_s": {t: round(n / dt, 2)
                         for t, n in stats["tokens_emitted"].items()},
        "slo": server.slo_summary(),
        "streams_digest": _streams_digest(server.results()),
        # the last busy decide's predicted makespans (analytical, seconds)
        "predicted_makespan_s": predicted,
        "events": [{"step": e.step, "reason": e.reason,
                    "sizes": e.sizes_after, "retuned": list(e.retuned),
                    "design": e.design, "seconds": round(e.seconds, 4),
                    "warm_compile_seconds": round(e.warm_compile_seconds, 4),
                    "warm_builds": e.warm_builds,
                    "overlapped": e.overlapped,
                    "post_step_seconds": {
                        t: round(s, 4)
                        for t, s in e.post_step_seconds.items()}}
                   for e in server.events],
    }, indent=1, default=list))
    return 0


def run_single(args) -> int:
    cfg = get_reduced(args.arch[0]) if args.reduced else \
        get_config(args.arch[0])
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
        "device": _device_name(model.device),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, action="append",
                    required=True, help="repeat for each fabric tenant")
    ap.add_argument("--fabric", action="store_true",
                    help="serve every --arch as a tenant of one fabric")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8,
                    help="requests (per tenant with --fabric)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-cus", type=int, default=8,
                    help="logical CUs the card is composed of")
    ap.add_argument("--decide-every", type=int, default=4)
    ap.add_argument("--no-warm", action="store_true",
                    help="recompose without capturing ahead")
    ap.add_argument("--prewarm-async", action="store_true",
                    help="warm candidate compositions in a background "
                         "thread; commit once warm")
    ap.add_argument("--split-only", action="store_true",
                    help="the split-only policy (no Stage 1)")
    args = ap.parse_args(argv)
    if args.fabric:
        return run_fabric(args)
    if len(args.arch) != 1:
        ap.error("one --arch without --fabric")
    return run_single(args)


if __name__ == "__main__":
    raise SystemExit(main())
