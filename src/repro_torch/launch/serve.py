"""Serving launcher of the port.

Single tenant:

    python -m repro_torch.launch.serve --arch minitron-4b [--reduced] \\
        [--device cpu] --requests N

builds the model with random weights from ``--seed``, warms the engine's
decode steps (``warm_compile``: CUDA graphs on the card) before the clock,
submits ``N`` requests with random prompts, runs the engine of the arch's
workload class until they finish and prints JSON stats, as
``repro.launch.serve`` does in single-model mode.

Multi-tenant fabric (``--fabric``, one ``--arch`` per tenant):

    python -m repro_torch.launch.serve --fabric --arch minitron-4b \\
        --arch falcon-mamba-7b [--reduced] [--device cpu] [--num-cus 8]

serves the tenants on one card composed of ``--num-cus`` logical CUs
(``ComposedServer``), with bursty per-tenant traffic, the two-stage
analytical policy (``--split-only`` for the split-only ablation) deciding
every ``--decide-every`` steps, and warm recomposition (``--no-warm`` off,
``--prewarm-async`` in a background thread).

Under ``torchrun`` with more than one rank (one rank per GPU under NCCL,
gloo CPU ranks with ``--device cpu``), or at a world of one with
``--mesh-fabric``, ``--fabric`` builds what the reference's
``run_fabric`` builds: the fabric over a (1, world) mesh, every column a
CU, each tenant tensor-parallel on its sub-mesh (``--no-tp``: whole on
each of its ranks), the policy pricing a CU as one GPU behind NVLink
(``H100_NVLINK``), SLO preemption (``--no-preempt`` off) and
``--prewarm-async``, every rank running the same schedule and rank 0
printing the document:

    torchrun --nproc-per-node 8 -m repro_torch.launch.serve --fabric \
        --scenario flash-crowd --reduced [--device cpu]
    python -m repro_torch.launch.serve --fabric --mesh-fabric \
        --arch minitron-4b --reduced [--device cpu]

The reference's mixed fleet (``MIXED_FLEET``: one tenant per workload
class, minitron-4b decode, falcon-mamba-7b SSM, qwen2.5-32b encoder and
seamless-m4t-medium enc-dec):

    python -m repro_torch.launch.serve --fabric --scenario mixed \\
        --reduced --device cpu

``--scenario diurnal``, ``flash-crowd`` or ``heavy-tail`` serves the fleet
under the seeded open-loop generator (``repro_torch.serve.traffic``) with
SLO targets attached (``--slo-*``, scoped by ``--slo-tenant``);
``--kv-frac`` below 1 oversubscribes the paged KV arena, so page
exhaustion preempts; ``--layers ARCH=N`` cuts an arch to N (decoder)
layers at its published widths.  Prints one JSON document on stdout:
recomposition events, per-class throughput, TTFT and the SLO summary and
attainment, the streams digest, the harness's step times and the last
busy decision's predicted makespans; ``--log-every`` writes a telemetry
line to stderr, ``--trace-out`` the span trace, ``--metrics-json`` the
merged metrics.

Smokes (exit 0 when they hold, on the mixed fleet, reduced):
``--obs-smoke`` (the trace carries recompose, decode-step and
warm-compile spans and every class has decode-step latencies) and
``--slo-smoke`` (a flash crowd on an oversubscribed paged arena preempts,
and every stream equals a slot-granular replay of the same schedule).

The reference's serving evidence for the paper's claim, one JSON document
each (the functions ``scaling_curve``, ``dse_smoke`` and ``dp_bench``
return it):

    python -m repro_torch.launch.serve --scaling-curve [--scale-steps 10]
    python -m repro_torch.launch.serve --dse-smoke [--reduced] \
        [--layers qwen2.5-32b=16]
    python -m repro_torch.launch.serve --dp-bench

``--scaling-curve`` measures decode tokens/s and step ms of a dense bench
model (``bench_config``: ``--scale-dmodel``, ``--scale-layers``,
``--scale-dff``, fp32) at each ``--scale-sizes`` grant of the card's
``--num-cus`` CUs, with ``--scale-slots-per-cu`` slots per CU.
``--dse-smoke`` serves two tenants (minitron-4b batch-capped at 4 slots
with 16 requests, qwen2.5-32b with 6) under the two-stage policy and
reports the design points Stage 1 picked and the fabric applied (exit 1
unless a non-default point with ``dp > 1`` was applied and every stream
completed, the reference's test).  ``--dp-bench`` times Stage 1's chosen
replica tiling of a 4-CU grant against the same grant forced to one
engine.  These modes run on one card, without a mesh: the documents keep
the reference's keys and ``tp`` reads false; the CUs are logical shares
(``CUComposer``), replicas are co-resident engines on shared weights,
each on its own CUDA stream, every engine is warmed before a timed
window, and every window ends on a device sync.

Tensor parallelism, under ``torchrun`` (one rank per GPU under NCCL;
gloo CPU ranks with ``--device cpu``):

    torchrun --nproc-per-node 8 -m repro_torch.launch.serve --tp-smoke \
        [--device cpu]
    torchrun ... -m repro_torch.launch.serve --arch qwen2.5-32b \
        --production-mesh [--no-tp] [--multi-pod]

``--tp-smoke`` serves minitron-reduced in fp32 (3 prompts, 2 slots,
``max_len`` 64) on a (1, world) mesh at TP 1 (replicated), TP 2, and TP 2
resharded to 1 and back to 2 mid-stream; it prints the reference's JSON
line and exits 1 unless the three streams are equal (2 at world 1).
``--production-mesh`` serves the single-tenant mode on the 16x16 (data,
model) mesh (``--multi-pod``: 2x16x16): each data row is an engine over
its 16 model columns with ``serve_engine_rules()`` (``--no-tp``: whole on
each rank), ``--max-slots`` split evenly over the rows, and request ``i``
goes to row ``i`` mod the row count; a world of another size exits 2
naming both.  Rank 0 prints, with its own row's captures.

Every mode runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.common.platform import H100_SXM, per_cu
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.composer import CUComposer, MeshComposer
from repro_torch.distribution import row_submeshes, serve_engine_rules
from repro_torch.launch.mesh import (init_world, make_production_mesh,
                                     make_serve_mesh)
from repro_torch.models.model import build_model
from repro_torch.serve import (AnalyticalPolicy, ComposedServer,
                               ReplicaGroup, SLOTarget, ServeConfig,
                               TenantDesignSpace, TenantSpec,
                               arrival_schedule)
from repro_torch.workloads import (DECODE, ENCODER, SSM, DecodeEngine,
                                   SSMEngine, workload_class_of)

ENGINES = {DECODE: DecodeEngine, SSM: SSMEngine}

# --scenario profiles served by the open-loop generator on the mixed fleet,
# with SLO targets attached
TRAFFIC_SCENARIOS = ("diurnal", "flash-crowd", "heavy-tail")

# the fleet of --scenario mixed and the traffic scenarios: one tenant per
# workload class, so the class-aware policy splits the card across all four
# bound resources (decode bandwidth, SSM state bandwidth, encoder compute,
# enc-dec decode plus cross-attention source reads)
MIXED_FLEET = (("decode", "minitron-4b"),
               ("ssm", "falcon-mamba-7b"),
               ("encoder", "qwen2.5-32b"),
               ("encdec", "seamless-m4t-medium"))


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _streams_digest(results) -> str:
    """Order-independent sha256 over every tenant's (rid -> token stream)
    map: equal digests mean identical serving output.  Float outputs
    (encoder embeddings) are left out: their bits follow the summation
    order, which the scheduling may change."""
    h = hashlib.sha256()
    for t in sorted(results):
        for rid in sorted(results[t]):
            arr = np.asarray(results[t][rid])
            if not np.issubdtype(arr.dtype, np.integer):
                continue
            h.update(f"{t}/{rid}:".encode())
            h.update(arr.tobytes())
            h.update(b";")
    return h.hexdigest()


def _telemetry_line(server, steps: int, toks: int, dt: float) -> str:
    """One line of serving summary (stderr): units/s, decode-step
    percentiles, fleet queue depth, the last recomposition's reason."""
    h = server.obs.registry.merged_histogram("decode_step_s")
    p50 = h.quantile(0.5) * 1e3 if h.count else 0.0
    p99 = h.quantile(0.99) * 1e3 if h.count else 0.0
    qd = sum(eng.queue_depth for eng in server.engines.values())
    reason = server.events[-1].reason if server.events else "-"
    return (f"[serve {dt:7.1f}s step {steps:5d}] "
            f"tok/s={toks / max(dt, 1e-9):7.1f} "
            f"step_ms p50={p50:.2f} p99={p99:.2f} "
            f"queue={qd} last_recompose={reason}")


def _layer_cuts(args):
    cuts = {}
    for item in args.layers or ():
        arch, n = item.split("=")
        cuts[arch] = int(n)
    return cuts


def fleet_tenants(args, serve: ServeConfig):
    """The tenants of a run: the mixed fleet for ``--scenario mixed`` and
    the traffic scenarios (with SLO targets on the traffic scenarios,
    scoped by ``--slo-tenant``), else one tenant per ``--arch``."""
    cuts = _layer_cuts(args)
    use_traffic = args.scenario in TRAFFIC_SCENARIOS
    if args.scenario == "mixed" or use_traffic:
        slo = (SLOTarget(ttft_p50_ms=args.slo_ttft_p50_ms,
                         ttft_p99_ms=args.slo_ttft_p99_ms,
                         per_token_p99_ms=args.slo_per_token_p99_ms)
               if use_traffic else None)
        return [TenantSpec(f"{w}-{arch}", arch, reduced=args.reduced,
                           serve=serve, seed=i, workload=w,
                           slo=(slo if args.slo_tenant in f"{w}-{arch}"
                                else None),
                           layers=cuts.get(arch, 0))
                for i, (w, arch) in enumerate(MIXED_FLEET)]
    return [TenantSpec(f"tenant{i}-{arch}", arch, reduced=args.reduced,
                       serve=serve, seed=i, layers=cuts.get(arch, 0))
            for i, arch in enumerate(args.arch)]


def fabric_mesh(args):
    """The mesh ``--fabric`` composes: (1, world) over ``torchrun``'s
    process group when it has more than one rank, or over a world of one
    started here with ``--mesh-fabric``; None (one card's CUs)
    otherwise."""
    import torch.distributed as dist

    device = torch.device(args.device).type
    world = init_world(device)
    if world == 1 and not args.mesh_fabric:
        return None
    if not dist.is_initialized():
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    return make_serve_mesh(device=device)


def serve_fabric(args, params=None, mesh=None):
    """Build the fabric of ``args``, serve its traffic and return
    ``(server, document, submitted)``: the document is what ``run_fabric``
    prints, ``submitted`` the (tenant, rid, tokens) of every request.
    ``params`` (tenant name -> weights) replaces random weights; ``mesh``
    composes its columns (``fabric_mesh``) instead of one card's CUs,
    every rank calling this together."""
    serve = ServeConfig(max_slots=args.max_slots, max_len=args.max_len,
                        eos_id=-1, kv_arena_frac=args.kv_frac,
                        kv_page_rows=args.kv_page_rows)
    tenants = fleet_tenants(args, serve)
    use_traffic = args.scenario in TRAFFIC_SCENARIOS
    # on a mesh the policy's default platform is a GPU behind NVLink
    policy = AnalyticalPolicy(
        per_cu(H100_SXM, args.num_cus) if mesh is None else None,
        two_stage=not args.split_only)
    server = ComposedServer(tenants, num_cus=args.num_cus,
                            device=args.device, policy=policy,
                            decide_every=args.decide_every,
                            warm=not args.no_warm,
                            prewarm_async=args.prewarm_async,
                            telemetry=not args.no_telemetry,
                            slo_preempt=not args.no_preempt, params=params,
                            mesh=mesh, tp=not args.no_tp)
    if not args.no_warm:
        for eng in server.engines.values():
            eng.warm_compile(None)
    rng = np.random.default_rng(args.seed)
    if use_traffic:
        # the seeded open-loop arrival process: the same seed replays the
        # same schedule
        queue = [(a.step, a.tenant, a.prompt_len, a.max_new)
                 for a in arrival_schedule(
                     args.scenario, [t.name for t in tenants],
                     args.requests, args.seed,
                     max_new=args.max_new_tokens)]
    else:
        # bursty: an arrival step per request over 4x the per-tenant
        # count, prompt lengths drawn at submit time
        queue = [(s, n, None, args.max_new_tokens)
                 for s, n in sorted((int(rng.integers(0, 4 * args.requests)),
                                     t.name)
                                    for t in tenants
                                    for _ in range(args.requests))]
    t0 = time.monotonic()
    steps = toks = 0
    predicted = None
    submitted = []
    # host time around each fabric step, the same with telemetry on or off
    harness_step_ms = []
    while queue or server.pending():
        while queue and queue[0][0] <= steps:
            _, name, plen, mnew = queue.pop(0)
            vocab = server.cfgs[name].vocab_size
            if plen is None:
                plen = int(rng.integers(4, 24))
            prompt = rng.integers(1, vocab, size=plen)
            submitted.append((name, server.submit(name, prompt,
                                                  max_new_tokens=mnew),
                              prompt))
        s0 = time.perf_counter()
        out = server.step()
        harness_step_ms.append((time.perf_counter() - s0) * 1e3)
        toks += sum(len(v) for v in out.values())
        if policy.predicted is not None:
            predicted = dict(policy.predicted)   # last busy decide's view
        steps += 1
        if args.log_every and steps % args.log_every == 0:
            # stderr: stdout carries exactly one JSON document
            print(_telemetry_line(server, steps, toks,
                                  time.monotonic() - t0), file=sys.stderr)
        if steps > 10_000:
            break
    server.drain(max_steps=2000)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    dt = time.monotonic() - t0
    stats = server.stats()
    arr = np.asarray(harness_step_ms if harness_step_ms else [0.0])
    # decode, ssm and enc-dec tenants emit tokens, encoder tenants
    # completed sequences (embeddings)
    throughput = {
        t: {"class": server.classes[t],
            "unit": ("seqs_per_s" if server.classes[t] == ENCODER
                     else "tokens_per_s"),
            "value": round(stats["tokens_emitted"][t] / dt, 2)}
        for t in server.engines}
    doc = {
        "device": _device_name(server.device),
        "tenants": [t.name for t in tenants], "scenario": args.scenario,
        "num_cus": server.composer.num_cus,
        "mesh": list(mesh.mesh.shape) if mesh is not None else None,
        "tp": server.rules is not None,
        "platform": policy.platform.name,
        "two_stage": not args.split_only,
        "decode_steps": steps, "wall_s": round(dt, 2), **stats,
        "telemetry": not args.no_telemetry,
        "harness_step_ms": {
            "p50": round(float(np.percentile(arr, 50)), 3),
            "p99": round(float(np.percentile(arr, 99)), 3),
            "n": len(harness_step_ms)},
        "tokens_per_s": {t: round(n / dt, 2)
                         for t, n in stats["tokens_emitted"].items()},
        "per_class_throughput": throughput,
        "slo": server.slo_summary(),
        "slo_attainment": server.slo_attainment(),
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
    }
    return server, doc, submitted


def run_fabric(args) -> int:
    """Traffic-driven multi-tenant serving on one recomposable card, or on
    a mesh (``fabric_mesh``; rank 0 prints)."""
    import torch.distributed as dist

    mesh = fabric_mesh(args)
    server, doc, _ = serve_fabric(args, mesh=mesh)
    if mesh is not None and dist.get_rank() != 0:
        return 0
    print(json.dumps(doc, indent=1, default=list))
    if args.trace_out:
        server.dump_trace(args.trace_out)
        print(f"trace written: {args.trace_out}", file=sys.stderr)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(server.metrics_snapshot(), f, indent=1)
        print(f"metrics written: {args.metrics_json}", file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# obs smoke: the telemetry pipeline must observe a mixed-fleet run
# ---------------------------------------------------------------------------

def run_obs_smoke(args) -> int:
    """Serve a short reduced mixed-fleet run with tracing on, export the
    trace, and require that it is valid trace-event JSON with at least one
    ``recompose``, decode-step and ``warm_compile`` span, and that every
    tenant class has decode-step latencies (the encoder records its
    batched encode under the same ``decode_step_s``)."""
    serve = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
    tenants = [TenantSpec(f"{w}-{arch}", arch, reduced=True, serve=serve,
                          seed=i, workload=w)
               for i, (w, arch) in enumerate(MIXED_FLEET)]
    server = ComposedServer(tenants, num_cus=args.num_cus,
                            device=args.device,
                            policy=AnalyticalPolicy(
                                per_cu(H100_SXM, args.num_cus)),
                            decide_every=3)
    rng = np.random.default_rng(args.seed)
    for t in server.engines:
        vocab = server.cfgs[t].vocab_size
        for _ in range(3):
            server.submit(t, rng.integers(1, vocab, size=8),
                          max_new_tokens=6)
    server.drain(max_steps=600)
    if server.stats()["recompositions"] == 0:
        # a quiet run: one forced recomposition exercises the span path
        sizes = server.sizes()
        lo = min(sizes, key=sizes.get)
        hi = max(sizes, key=sizes.get)
        sizes[lo], sizes[hi] = sizes[lo] + 1, sizes[hi] - 1
        server.recompose(sizes, reason="obs-smoke")
        server.drain(max_steps=200)
    trace_path = args.trace_out
    if not trace_path:
        # the checkout's build directory, which git ignores
        os.makedirs("build", exist_ok=True)
        trace_path = os.path.join("build", "obs_smoke_trace.json")
    server.dump_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    names = [e.get("name") for e in events]
    schema_ok = all(
        isinstance(e.get("ts"), (int, float))
        and isinstance(e.get("dur"), (int, float))
        and e.get("ph") == "X" and e.get("name")
        for e in events)
    merged = server.metrics()
    hist_by_class = {
        server.classes[t]:
            merged.merged_histogram("decode_step_s", tenant=t).count
        for t in server.engines}
    checks = {
        "trace_events": len(events),
        "trace_schema_ok": bool(events) and schema_ok,
        "recompose_spans": names.count("recompose"),
        "decode_step_spans": sum(n in ("decode_step", "encode_step")
                                 for n in names),
        "warm_compile_spans": names.count("warm_compile"),
        "decode_step_hist_by_class": hist_by_class,
    }
    ok = (checks["trace_schema_ok"]
          and checks["recompose_spans"] >= 1
          and checks["decode_step_spans"] >= 1
          and checks["warm_compile_spans"] >= 1
          and all(n > 0 for n in hist_by_class.values()))
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(server.metrics_snapshot(), f, indent=1)
    print(json.dumps({**checks, "trace_path": trace_path, "ok": ok}))
    if not ok:
        print("obs smoke FAILED: the trace lost spans or a class lost its "
              "decode-step latencies (see the checks)", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# SLO smoke: a flash crowd must preempt, and streams must not change
# ---------------------------------------------------------------------------

def run_slo_smoke(args) -> int:
    """A flash crowd over the reduced mixed fleet on an oversubscribed
    paged arena (``kv_arena_frac`` 0.4) must preempt at least one live
    stream, every request must complete its budget, the streams must equal
    a slot-granular replay of the same schedule without SLO preemption
    (preemption saves exact device state; greedy rows do not depend on
    their batch), and the SLO attainment must not be empty."""
    requests, mnew = max(args.requests, 6), 24
    names = [f"{w}-{arch}" for w, arch in MIXED_FLEET]

    def build(paged: bool) -> ComposedServer:
        serve = ServeConfig(max_slots=3, max_len=64, eos_id=-1,
                            paged_kv=paged, kv_page_rows=8,
                            kv_arena_frac=0.4 if paged else 1.0)
        slo = (SLOTarget(ttft_p50_ms=100.0, ttft_p99_ms=400.0)
               if paged else None)
        tenants = [TenantSpec(f"{w}-{arch}", arch, reduced=True,
                              serve=serve, seed=i, workload=w, slo=slo)
                   for i, (w, arch) in enumerate(MIXED_FLEET)]
        # no policy: the smoke pins scheduling behaviour, not the DSE
        return ComposedServer(tenants, num_cus=args.num_cus,
                              device=args.device, policy=None,
                              slo_preempt=paged)

    sched = arrival_schedule("flash-crowd", names, requests, args.seed,
                             max_new=mnew)

    def run(server: ComposedServer):
        rng = np.random.default_rng(args.seed)
        queue = [(a.step, a.tenant, a.prompt_len, a.max_new) for a in sched]
        steps = 0
        while queue or server.pending():
            while queue and queue[0][0] <= steps:
                _, name, plen, mn = queue.pop(0)
                vocab = server.cfgs[name].vocab_size
                server.submit(name, rng.integers(1, vocab, size=plen),
                              max_new_tokens=mn)
            server.step()
            steps += 1
            if steps > 4000:
                break
        server.drain(max_steps=1000)
        return server.results()

    paged = build(True)
    res_paged = run(paged)
    res_base = run(build(False))
    stats = paged.stats()
    preemptions = sum(stats["preemptions"].values())
    att = paged.slo_attainment()
    complete = all(
        len(units) == mnew
        for t, streams in res_paged.items()
        if paged.classes[t] != ENCODER
        for units in streams.values())
    digest_paged = _streams_digest(res_paged)
    checks = {
        "preemptions": preemptions,
        "slo_preemptions": stats["slo_preemptions"],
        "complete": complete,
        "digest_match": digest_paged == _streams_digest(res_base),
        "attainment_tenants": sorted(att["tenants"]),
        "streams_digest": digest_paged,
    }
    ok = (preemptions >= 1 and complete and checks["digest_match"]
          and bool(att["tenants"]))
    print(json.dumps({**checks, "ok": ok}))
    if not ok:
        print("SLO smoke FAILED: the flash crowd did not preempt, or a "
              "stream diverged or never completed (see the checks)",
              file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# tokens/s by CU count: the measured scaling curve
# ---------------------------------------------------------------------------

def bench_config(d_model: int, layers: int, d_ff: int) -> ModelConfig:
    """The reference's dense decode-bench model: fp32, head dim 128, half
    as many KV heads as query heads, vocab 2048."""
    heads = max(d_model // 128, 1)
    return ModelConfig(
        name=f"serve-bench-d{d_model}-L{layers}", family="dense",
        num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=max(heads // 2, 1), d_ff=d_ff, vocab_size=2048,
        head_dim=128, attn_type="full", dtype="float32", remat=False)


def _bench_model(cfg: ModelConfig, args):
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    return model, model.init(gen)


def scaling_curve(args) -> dict:
    """Steady-state decode tokens/s at each grant size of ``--scale-sizes``
    (sizes above ``--num-cus`` are dropped): CUs granted by the policy
    buy throughput.

    A grant of ``k`` CUs holds ``k * --scale-slots-per-cu`` decode slots,
    and that is all it is here: on one card a grant is a share and no SM
    is partitioned, so the engine runs on the whole card and the curve
    measures slots rising with the grant; decode
    at small batch is weights-bound, so step ms stays about flat while
    tokens/s follows the slots.  Each engine is warmed (``warm_compile``
    and the reference's 3 steps) before its windows; each of the two
    windows of ``--scale-steps`` steps ends on a device sync, and the
    best is kept.  ``captures_in_windows`` counts graph captures inside
    the windows (0 when warming covered them)."""
    cfg = bench_config(args.scale_dmodel, args.scale_layers, args.scale_dff)
    model, params = _bench_model(cfg, args)
    sizes = [s for s in args.scale_sizes if s <= args.num_cus]
    M = args.scale_steps
    curve, lat, slots, captures = {}, {}, {}, {}
    for size in sizes:
        B = args.scale_slots_per_cu * size
        eng = DecodeEngine(model, params, ServeConfig(
            max_slots=B, max_len=args.max_len, eos_id=-1))
        eng.warm_compile(None)
        rng = np.random.default_rng(args.seed)
        for _ in range(B):
            eng.submit(rng.integers(1, cfg.vocab_size, size=16),
                       max_new_tokens=3 * M + 8)
        for _ in range(3):                    # prefill + the first steps
            eng.step()
        eng.warm_compile(None)                # the bounds about to dispatch
        eng.sync()
        before = eng.graph_captures
        best, steps_ms = 0.0, []
        for _ in range(2):                    # best-of-2 absorbs host jitter
            t0 = time.perf_counter()
            for _ in range(M):
                s0 = time.perf_counter()
                eng.step()
                steps_ms.append((time.perf_counter() - s0) * 1e3)
            eng.sync()
            best = max(best, B * M / (time.perf_counter() - t0))
        curve[size], slots[size] = round(best, 2), B
        captures[size] = eng.graph_captures - before
        arr = np.asarray(steps_ms)
        lat[size] = {"p50": round(float(np.percentile(arr, 50)), 2),
                     "p95": round(float(np.percentile(arr, 95)), 2)}
        del eng
    monotone = all(curve[a] < curve[b] for a, b in zip(sizes, sizes[1:]))
    return {
        "device": _device_name(model.device), "num_cus": args.num_cus,
        "bench_model": cfg.name, "measured_steps": M, "tp": False,
        "slots_by_cus": {str(s): slots[s] for s in sizes},
        "tokens_per_s_by_cus": {str(s): curve[s] for s in sizes},
        "step_ms_by_cus": {str(s): lat[s] for s in sizes},
        "captures_in_windows": {str(s): captures[s] for s in sizes},
        "monotone": monotone,
    }


def run_scaling(args) -> int:
    print(json.dumps(scaling_curve(args), indent=1))
    return 0


# ---------------------------------------------------------------------------
# DSE smoke: Stage 1 must pick a non-default design point, applied live
# ---------------------------------------------------------------------------

def _stage1_log(policy: AnalyticalPolicy, server: ComposedServer) -> list:
    """Record every ``policy.decide`` of ``server`` as {"event": the index
    its recomposition event would take, "points": the per-tenant points};
    the list fills as the server runs."""
    log, decide = [], policy.decide

    def recorded(observations, cfgs, current, num_cus):
        points, reason = decide(observations, cfgs, current, num_cus)
        log.append({"event": len(server.events), "reason": reason,
                    "points": {t: {"cus": p.cus, "tp": p.tp,
                                   "slots": p.slots, "dp": p.dp}
                               for t, p in points.items()}})
        return points, reason

    policy.decide = recorded
    return log


def _delta_chosen(delta: dict, pick: dict) -> bool:
    """An applied knob delta is Stage 1's pick: the same ``dp``, and the
    same slots or more (a shrink clamps at the live occupancy)."""
    return (delta.get("dp", pick["dp"]) == pick["dp"]
            and delta.get("slots", pick["slots"]) >= (pick["slots"] or 0)
            and "tp" not in delta)


def dse_smoke(args, policy=None):
    """Two tenants under the two-stage policy: tenant "a" (minitron-4b,
    its batch capped at 4 slots per engine, 16 requests) and "b"
    (qwen2.5-32b, 6 requests), 2 slots and ``max_len`` 48 each, 8-token
    prompts, 10 new tokens, a decision every 3 steps; ``--reduced`` and
    ``--layers`` cut the configs.  Returns ``(server, document,
    submitted)``: the document holds the reference's fields
    (``design_points``, ``applied_deltas``, ``nondefault``, ``dp_picked``,
    ``complete``, ``ok``), Stage 1's pick behind each recomposition
    (``stage1_picks``), whether every applied delta was Stage 1's
    (``deltas_from_stage1``) and the captures on the serving path after
    warming; ``submitted`` is (tenant, rid, prompt) per request.
    ``policy`` replaces the default ``AnalyticalPolicy`` on
    ``per_cu(H100_SXM, --num-cus)``."""
    if args.num_cus < 4:
        raise ValueError(f"dse-smoke needs >= 4 CUs, got {args.num_cus}")
    cuts = _layer_cuts(args)
    sc = ServeConfig(max_slots=2, max_len=48, eos_id=-1)
    # a: batch capped at 4 slots per engine, so a deep queue on a wide
    # grant is servable only by replica tiling (the dp axis)
    sc_a = dataclasses.replace(sc, slot_cap=4)
    tenants = [TenantSpec("a", "minitron-4b", reduced=args.reduced,
                          serve=sc_a, layers=cuts.get("minitron-4b", 0)),
               TenantSpec("b", "qwen2.5-32b", reduced=args.reduced, seed=1,
                          serve=sc, layers=cuts.get("qwen2.5-32b", 0))]
    if policy is None:
        policy = AnalyticalPolicy(per_cu(H100_SXM, args.num_cus))
    server = ComposedServer(tenants, num_cus=args.num_cus,
                            device=args.device, policy=policy,
                            decide_every=3)
    for eng in server.engines.values():
        eng.warm_compile(None)
    decisions = _stage1_log(policy, server)
    rng = np.random.default_rng(args.seed)
    submitted = []
    for t, n in (("a", 16), ("b", 6)):     # queue depth >> default slots
        vocab = server.cfgs[t].vocab_size
        for _ in range(n):
            prompt = rng.integers(1, vocab, size=8)
            submitted.append((t, server.submit(t, prompt, max_new_tokens=10),
                              prompt))
    t0 = time.monotonic()
    try:
        out = server.drain(max_steps=500)
    finally:
        del policy.decide                  # the policy's own method again
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    dt = time.monotonic() - t0
    stats = server.stats()
    events = list(server.events)
    applied = {t: d for e in events for t, d in e.design.items()}
    nondefault = {
        t: d for t, d in stats["design_points"].items()
        if d["slots"] != sc.max_slots
        or (d["tp"] is not None and 0 < d["tp"] < d["cus"])}
    # dp > 1 is a steady-load design: once the fleet drains the policy
    # folds "a" back to one engine, so look over the event history
    dp_picked = any(e.design.get("a", {}).get("dp", 1) > 1
                    and e.sizes_after.get("a", 0) >= 4 for e in events)
    complete = all(len(toks) == 10
                   for streams in out.values() for toks in streams.values())
    picks = []
    for i, e in enumerate(events):
        pick = [d for d in decisions if d["event"] == i][-1]
        picks.append({"step": e.step, "reason": e.reason,
                      "points": pick["points"]})
    from_stage1 = all(_delta_chosen(d, pick["points"][t])
                      for e, pick in zip(events, picks)
                      for t, d in e.design.items())
    ok = bool(nondefault) and bool(applied) and dp_picked and complete
    doc = {"device": _device_name(server.device),
           "tenants": {t: spec.arch for t, spec in server.specs.items()},
           "reduced": args.reduced,
           "layers": {t: server.cfgs[t].num_layers for t in server.cfgs},
           "num_cus": args.num_cus, "decode_steps": stats["steps"],
           "wall_s": round(dt, 3),
           "design_points": stats["design_points"],
           "applied_deltas": applied,
           "nondefault": sorted(nondefault),
           "dp_picked": dp_picked, "complete": complete, "ok": ok,
           "stage1_picks": picks, "deltas_from_stage1": from_stage1,
           "serving_captures": stats["serving_captures"],
           "tokens_emitted": stats["tokens_emitted"],
           "events": [{"step": e.step, "reason": e.reason,
                       "sizes": e.sizes_after, "design": e.design}
                      for e in events]}
    return server, doc, submitted


def run_dse_smoke(args) -> int:
    if args.num_cus < 4:
        print("dse-smoke needs >= 4 CUs (--num-cus)")
        return 2
    _, doc, _ = dse_smoke(args)
    print(json.dumps(doc, default=list))
    if not doc["ok"]:
        print("DSE smoke FAILED: Stage 1 never picked (or the fabric never "
              "applied) a non-default design point with dp > 1",
              file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# dp bench: Stage-1-chosen replica tiling vs the same grant forced to dp=1
# ---------------------------------------------------------------------------

def dp_bench(args, policy=None):
    """Steady-state decode tokens/s on one 4-CU grant: Stage 1's chosen
    design against the same search with the tenant pinned to a single
    engine (``dp_cap=1``).  The engine's batch is capped (``slot_cap``
    4), so the single engine never widens its batch while the replica
    arm decodes ``dp`` capped batches at once: co-resident engines on the
    shared weights, each on its own CUDA stream.

    Stage 1 searches the reference's design space, which prices tensor
    parallelism; one card runs none, so each arm applies its point's
    ``dp`` and ``slots`` (``chosen``/``forced`` report the points as
    priced).  Both arms are built, warmed and then timed in turns, best of
    3 windows of ``--scale-steps`` steps each, every window ending on a
    device sync; then both run to completion.  Returns ``(document,
    results)``: ``results`` maps "dp" and "dp1" to each arm's {rid:
    tokens}, the same requests in the same order."""
    if args.num_cus < 4:
        raise ValueError(f"dp-bench needs >= 4 CUs, got {args.num_cus}")
    # deep-narrow at a long context, the reference's regime; the fixed
    # max_len (not --max-len) is part of the benchmark
    cfg = bench_config(512, 6, 4096)
    model, params = _bench_model(cfg, args)
    comp = CUComposer(args.num_cus, model.device)
    grant, queue, M, reps = 4, 16, args.scale_steps, 3
    sc = ServeConfig(max_slots=4, max_len=4096, eos_id=-1, slot_cap=4)
    pol = (policy if policy is not None
           else AnalyticalPolicy(per_cu(H100_SXM, args.num_cus)))

    def arm(dp_cap):
        space = TenantDesignSpace(wclass=DECODE, max_len=sc.max_len,
                                  base_slots=sc.max_slots,
                                  slot_cap=sc.slot_cap, dp_cap=dp_cap)
        best = pol.stage1.best(cfg, space, queue, grant)
        grp = ReplicaGroup(DECODE, model, params, sc,
                           sub=comp.submesh(range(grant), f"dpb{dp_cap}"))
        grp.apply(None, dataclasses.replace(best, tp=None))
        grp.warm_compile(None)
        rng = np.random.default_rng(args.seed)
        for _ in range(queue):
            grp.submit(rng.integers(1, cfg.vocab_size, size=16),
                       max_new_tokens=reps * M + 8)
        for _ in range(3):                  # prefill + the first steps
            grp.step()
        grp.warm_compile(None)              # the bounds about to dispatch
        grp.sync()
        return best, grp

    chosen, grp_dp = arm(dp_cap=64)
    forced, grp_one = arm(dp_cap=1)
    toks = {"dp": 0.0, "dp1": 0.0}
    captures = {"dp": 0, "dp1": 0}
    for _ in range(reps):
        for grp, which in ((grp_dp, "dp"), (grp_one, "dp1")):
            before = grp.graph_captures
            n, t0 = 0, time.perf_counter()
            for _ in range(M):
                n += len(grp.step())
            grp.sync()
            toks[which] = max(toks[which],
                              round(n / (time.perf_counter() - t0), 2))
            captures[which] += grp.graph_captures - before
    results = {"dp": grp_dp.run_to_completion(2000),
               "dp1": grp_one.run_to_completion(2000)}
    complete = all(len(v) == reps * M + 8
                   for res in results.values() for v in res.values())
    ok = (chosen.dp or 1) > 1 and (forced.dp or 1) == 1 \
        and toks["dp"] > toks["dp1"]
    doc = {
        "device": _device_name(model.device), "num_cus": comp.num_cus,
        "bench_model": cfg.name, "grant_cus": grant, "queue": queue,
        "measured_steps": M, "timed_reps": reps, "slot_cap": sc.slot_cap,
        "tp": False,
        "chosen": {"dp": chosen.dp, "tp": chosen.tp, "slots": chosen.slots},
        "forced": {"dp": forced.dp, "tp": forced.tp, "slots": forced.slots},
        "applied_dp": {"dp": grp_dp.dp, "dp1": grp_one.dp},
        "tokens_per_s_dp": toks["dp"], "tokens_per_s_dp1": toks["dp1"],
        "speedup": round(toks["dp"] / max(toks["dp1"], 1e-9), 3),
        "captures_in_windows": captures, "complete": complete,
        "streams_equal": results["dp"] == results["dp1"], "ok": ok,
    }
    return doc, results


def run_dp_bench(args) -> int:
    if args.num_cus < 4:
        print("dp-bench needs >= 4 CUs (--num-cus)")
        return 2
    doc, _ = dp_bench(args)
    print(json.dumps(doc))
    if not doc["ok"]:
        print("dp bench FAILED: Stage 1 did not pick dp > 1, or replica "
              "tiling did not beat the single-engine arm", file=sys.stderr)
        return 1
    return 0


def run_tp_smoke(args) -> int:
    """TP 2 and a mid-stream reshard to TP 1 and back against TP 1
    replicated, on a (1, world) mesh: the three streams must be equal (the
    reference's ``run_tp_smoke``)."""
    import torch.distributed as dist

    if init_world(torch.device(args.device).type) < 2:
        print("tp-smoke needs >= 2 devices (torchrun --nproc-per-node 8 "
              "-m repro_torch.launch.serve --tp-smoke [--device cpu])")
        return 2
    mesh = make_serve_mesh(device=torch.device(args.device).type)
    comp = MeshComposer(mesh)
    cfg = dataclasses.replace(get_reduced("minitron-4b"), dtype="float32")
    model = build_model(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(
        args.seed))
    sc = ServeConfig(max_slots=2, max_len=64, eos_id=-1)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 12)))
               for _ in range(3)]

    def run(tp, rules, reshard_at=None):
        eng = DecodeEngine(model, params, sc,
                           mesh=comp.submesh(range(tp), f"tp{tp}"),
                           rules=rules)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        step = 0
        while eng.has_work:
            if reshard_at and step in reshard_at:
                eng.reshard_to(comp.submesh(range(reshard_at[step]), "re"))
            eng.step()
            step += 1
            assert step < 200
        return eng.results()

    ref = run(1, None)                                 # replicated baseline
    tp2 = run(2, serve_engine_rules())
    dyn = run(2, serve_engine_rules(), reshard_at={4: 1, 8: 2})
    ok = ref == tp2 == dyn
    if dist.get_rank() == 0:
        print(json.dumps({"match_tp2": tp2 == ref, "match_dyn": dyn == ref,
                          "requests": len(ref), "ok": ok}))
        print("TP smoke OK: 2-way TP and mid-stream reshard match "
              "replicated" if ok else "TP smoke FAILED: sharded decode "
              "diverged from replicated")
    return 0 if ok else 1


def _serving_mesh(args):
    """(mesh, rules, error) of ``--production-mesh``: the mesh over
    torchrun's process group, or the message of a world that cannot hold
    it."""
    if not args.production_mesh:
        return None, None, None
    device = torch.device(args.device).type
    if init_world(device) == 1 and "RANK" not in os.environ:
        return None, None, ("--production-mesh runs under torchrun (RANK "
                            "and WORLD_SIZE unset)")
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
    except ValueError as e:
        return None, None, str(e)
    return mesh, None if args.no_tp else serve_engine_rules(), None


def row_engines(cls, model, params, sc: ServeConfig, mesh, rules):
    """One engine per data row of a serving mesh (``row_submeshes``), each
    over its row's model columns (tensor-parallel under ``rules``, whole on
    each rank without) with ``max_slots`` split evenly over the rows, as
    the reference's rules split the slots' batch dim over the data dims.
    Every rank builds every row's engine, in the same order, and does
    device work only for its own row's."""
    rows = row_submeshes(mesh)
    rsc = dataclasses.replace(sc, max_slots=max(sc.max_slots // len(rows),
                                                1))
    return [cls(model, params, rsc, mesh=row, rules=rules) for row in rows]


def serve_rows(engines, prompts, max_new_tokens: int):
    """Request ``i`` to engine ``i % len(engines)``; each round steps every
    engine that has work, until none has.  Returns (streams by request
    index, rounds, tokens emitted, each round's ms)."""
    placed = []
    for i, p in enumerate(prompts):
        eng = engines[i % len(engines)]
        placed.append((eng, eng.submit(p, max_new_tokens=max_new_tokens)))
    rounds = emitted = 0
    round_ms = []
    while any(e.has_work for e in engines) and rounds <= 10_000:
        s0 = time.perf_counter()
        for e in engines:
            if e.has_work:
                emitted += len(e.step())
        round_ms.append((time.perf_counter() - s0) * 1e3)
        rounds += 1
    results = {id(e): e.results() for e in engines}
    streams = {i: list(results[id(e)][rid])
               for i, (e, rid) in enumerate(placed)}
    return streams, rounds, emitted, round_ms


def run_single(args) -> int:
    mesh, rules, err = _serving_mesh(args)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
    cfg = get_reduced(args.arch[0]) if args.reduced else \
        get_config(args.arch[0])
    cuts = _layer_cuts(args)
    if args.arch[0] in cuts:
        cfg = dataclasses.replace(cfg, num_layers=cuts[args.arch[0]])
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    cls = ENGINES[workload_class_of(cfg)]
    sc = ServeConfig(max_slots=args.max_slots, max_len=args.max_len,
                     eos_id=-1)
    engines = (row_engines(cls, model, params, sc, mesh, rules)
               if mesh is not None else [cls(model, params, sc)])
    warm_builds = sum(e.warm_compile(None) for e in engines)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 24)))
               for _ in range(args.requests)]
    _, steps, emitted, step_ms = serve_rows(engines, prompts,
                                            args.max_new_tokens)
    dt = time.monotonic() - t0
    arr = np.asarray(step_ms)
    if mesh is not None and mesh.get_rank() != 0:
        return 0
    engine = engines[0]            # rank 0's row
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
        "mesh": list(mesh.mesh.shape) if mesh is not None else None,
        "rows": len(engines) if mesh is not None else None,
        "tp": rules is not None,
    }, indent=1))
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, action="append",
                    help="repeat for each fabric tenant")
    ap.add_argument("--fabric", action="store_true",
                    help="serve every --arch as a tenant of one fabric")
    ap.add_argument("--scenario",
                    choices=["bursty", "mixed"] + list(TRAFFIC_SCENARIOS),
                    default="bursty",
                    help="fabric traffic: 'bursty' serves the --arch "
                         "tenants; 'mixed' the four-class fleet; the "
                         "traffic profiles serve that fleet under the "
                         "seeded open-loop generator with SLO targets")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8,
                    help="requests (per tenant with --fabric)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", action="append", metavar="ARCH=N",
                    help="cut ARCH to N (decoder) layers at its published "
                         "widths; repeatable")
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
    ap.add_argument("--no-telemetry", action="store_true",
                    help="no metrics registry or span tracer (streams are "
                         "the same either way)")
    ap.add_argument("--metrics-json", metavar="PATH",
                    help="write the merged metrics snapshot as JSON")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write the span trace as trace-event JSON")
    ap.add_argument("--log-every", type=int, default=200, metavar="N",
                    help="a telemetry line on stderr every N fabric steps "
                         "(0: none)")
    ap.add_argument("--kv-frac", type=float, default=1.0,
                    help="KV arena size as a share of the slots' worst "
                         "case (< 1 oversubscribes: page exhaustion "
                         "preempts)")
    ap.add_argument("--kv-page-rows", type=int, default=16,
                    help="token rows per KV page")
    ap.add_argument("--no-preempt", action="store_true",
                    help="no SLO preemption (attainment still reported)")
    ap.add_argument("--slo-ttft-p50-ms", type=float, default=150.0)
    ap.add_argument("--slo-ttft-p99-ms", type=float, default=400.0)
    ap.add_argument("--slo-per-token-p99-ms", type=float, default=0.0,
                    help="per-token p99 target (0: untracked)")
    ap.add_argument("--slo-tenant", default="", metavar="SUBSTR",
                    help="SLO targets only for tenants whose name holds "
                         "SUBSTR (empty: every tenant)")
    ap.add_argument("--obs-smoke", action="store_true",
                    help="require the telemetry to trace a mixed-fleet run")
    ap.add_argument("--slo-smoke", action="store_true",
                    help="require a flash crowd on an oversubscribed paged "
                         "arena to preempt, with streams equal to a "
                         "slot-granular replay")
    ap.add_argument("--scaling-curve", action="store_true",
                    help="measure decode tokens/s at each --scale-sizes "
                         "grant of the card's CUs")
    ap.add_argument("--scale-sizes", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--scale-steps", type=int, default=10)
    ap.add_argument("--scale-slots-per-cu", type=int, default=4,
                    help="decode slots per granted CU")
    ap.add_argument("--scale-dmodel", type=int, default=2048)
    ap.add_argument("--scale-layers", type=int, default=4)
    ap.add_argument("--scale-dff", type=int, default=8192)
    ap.add_argument("--dse-smoke", action="store_true",
                    help="require the two-stage policy to pick and apply a "
                         "non-default design point (dp > 1 for the "
                         "batch-capped tenant)")
    ap.add_argument("--dp-bench", action="store_true",
                    help="time Stage 1's replica tiling (dp > 1) against "
                         "the same grant forced to one engine")
    ap.add_argument("--tp-smoke", action="store_true",
                    help="require TP 2 decode, and a mid-stream reshard to "
                         "TP 1 and back, to equal replicated decode "
                         "(torchrun, >= 2 ranks)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="serve on the 16x16 production mesh (torchrun, "
                         "256 ranks)")
    ap.add_argument("--mesh-fabric", action="store_true",
                    help="with --fabric at a world of one: compose a "
                         "(1, 1) mesh (the policy, Stage 1 and the engines "
                         "on a mesh) instead of one card's CUs; torchrun "
                         "worlds of more ranks always do")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: 2x16x16 (512 ranks)")
    ap.add_argument("--no-tp", action="store_true",
                    help="with --production-mesh or --fabric on a mesh: "
                         "replicated engines")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.tp_smoke:
        return run_tp_smoke(args)
    if args.obs_smoke:
        return run_obs_smoke(args)
    if args.slo_smoke:
        return run_slo_smoke(args)
    if args.dse_smoke:
        return run_dse_smoke(args)
    if args.dp_bench:
        return run_dp_bench(args)
    if args.scaling_curve:
        return run_scaling(args)
    if args.scenario == "mixed" or args.scenario in TRAFFIC_SCENARIOS:
        if not args.fabric:
            ap.error(f"--scenario {args.scenario} requires --fabric")
        if args.arch:
            ap.error(f"--scenario {args.scenario} picks its own fleet; "
                     "drop --arch")
        return run_fabric(args)
    if not args.arch:
        ap.error("--arch is required (except with --scenario mixed or a "
                 "traffic scenario, the smokes, --dp-bench and "
                 "--scaling-curve)")
    if args.fabric:
        return run_fabric(args)
    if len(args.arch) != 1:
        ap.error("one --arch without --fabric")
    return run_single(args)


if __name__ == "__main__":
    raise SystemExit(main())
