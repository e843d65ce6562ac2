#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the CUDA version
   and capability, and builds the port's CUDA kernels from this checkout
   into ``build/kernels/``.
2. Kernel phase: each kernel against its plain PyTorch version on the same
   inputs at the serving path's shapes (minitron-4b heads, bf16; ragged
   decode lengths with a dead slot and lengths that are no multiple of the
   tile; prefill lengths 32, 200 and 1024), with its time, the plain
   version's, one PyTorch library call's as a yardstick, and its bound.
3. Serving phase: full-width minitron-4b (32 layers, random bf16 weights
   from a fixed seed) through ``DecodeEngine`` with the kernels on: 8
   requests of 100-1000 prompt tokens and 32 new tokens each.  Asserts that
   every layer of every prefill and decode step launched its kernel.
4. Reference check: on one short prompt, the kernel path's logits against
   the plain path's (prefill and four decode steps), within a stated bound.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device,
outside a checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # fp32 outside the tensor cores
# bf16 kernel vs plain version: outputs are O(1) weighted means of bf16
# values; the two round p and the running sums at different points, so
# they may differ by a few bf16 ulps (2**-8 relative).  fp32: summation
# order only.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# full-depth logits, kernel path vs plain path: bf16 rounding at different
# points compounds over 32 layers; bound relative to the largest |logit|.
LOGIT_REL_TOL = 5e-2


def log(*parts) -> None:
    print(*parts, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke.py: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` launches, each timed
    with CUDA events after a write of 256 MB that evicts the 50 MB L2, as
    the serving path finds its inputs cold (weights pass between layers)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound(nbytes: float, flops: float, dtype: str):
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_case(torch, gen, *, lengths, live, T_full, dtype, Hq=24, Hkv=8,
                D=128):
    B = len(lengths)
    dt = getattr(torch, dtype)
    q = torch.randn((B, 1, Hq, D), generator=gen, device="cuda").to(dt)
    kc = torch.randn((B, T_full, Hkv, D), generator=gen, device="cuda").to(dt)
    vc = torch.randn((B, T_full, Hkv, D), generator=gen, device="cuda").to(dt)
    bound_rows = -(-max(lengths) // 32) * 32
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    livet = torch.tensor(live, dtype=torch.bool, device="cuda")
    # the engine's bounded strided view of the pooled cache, never copied
    return q, kc[:, :bound_rows], vc[:, :bound_rows], lens, livet


def run_kernel_phase(torch, reps: int = 20):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_decode.ref import \
        ragged_decode_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    F = torch.nn.functional
    results = {}

    # -- ragged decode ------------------------------------------------------
    lengths = [1000, 517, 129, 1, 64, 999, 700, 333]
    live = [1, 1, 1, 1, 1, 1, 0, 1]            # slot 6 is dead
    cases = [
        ("bf16 main", dict(dtype="bfloat16"), {}),
        ("bf16 window+cap+global", dict(dtype="bfloat16"),
         dict(window=256, logit_cap=30.0, is_global=True)),
        ("bf16 window+cap", dict(dtype="bfloat16"),
         dict(window=256, logit_cap=30.0)),
        ("fp32 main", dict(dtype="float32"), {}),
    ]
    worst = 0.0
    for name, dk, kw in cases:
        q, k, v, lens, livet = decode_case(torch, gen, lengths=lengths,
                                           live=live, T_full=2048, **dk)
        got = rd.ragged_decode_attention(q, k, v, lens, live=livet, **kw)
        want = ragged_decode_attention_ref(q, k, v, lens, live=livet, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        dead_zero = bool((got[6] == 0).all().item())
        tol = TOL[dk["dtype"]]
        log(f"ragged_decode {name}: B={q.shape[0]} T={k.shape[1]} "
            f"max_abs_err={err:.3e} tol={tol:.0e} dead_row_zero={dead_zero}")
        if not (err <= tol and dead_zero and math.isfinite(err)):
            raise SystemExit(f"ragged_decode {name} disagrees with its "
                             f"plain version")
        if dk["dtype"] == "bfloat16":
            worst = max(worst, err)
    q, k, v, lens, livet = decode_case(torch, gen, lengths=lengths,
                                       live=live, T_full=2048,
                                       dtype="bfloat16")
    ms = time_ms(torch, lambda: rd.ragged_decode_attention(
        q, k, v, lens, live=livet), reps)
    plain_ms = time_ms(torch, lambda: ragged_decode_attention_ref(
        q, k, v, lens, live=livet), max(reps // 4, 3))
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    qh = q.transpose(1, 2)                                  # (B, Hq, 1, D)
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2)    # (B, Hq, T, D)
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), reps)
    live_len = sum(n for n, a in zip(lengths, live) if a)
    es = q.element_size()
    nbytes = (2 * live_len * Hkv * D * es + 2 * B * Hq * D * es + 8 * B)
    flops = 4 * live_len * Hq * D
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    log(f"ragged_decode timing (B={B} T={k.shape[1]} Hq={Hq} Hkv={Hkv} "
        f"D={D} bf16, live KV rows {live_len}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    results["ragged_decode"] = dict(
        name="ragged_decode", route="cuda",
        source="src/repro_torch/kernels/ragged_decode/csrc/ragged_decode.cu",
        replaces="src/repro/kernels/ragged_decode/kernel.py:86",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)

    # -- prefill flash attention -------------------------------------------
    worst = 0.0
    timing = {}
    pcases = [(32, "bfloat16", {}), (200, "bfloat16", {}),
              (1024, "bfloat16", {}),
              (200, "bfloat16", dict(window=64, logit_cap=30.0)),
              (200, "bfloat16", dict(window=64, logit_cap=30.0,
                                     is_global=True)),
              (200, "float32", {})]
    for S, dtype, kw in pcases:
        dt = getattr(torch, dtype)
        q = torch.randn((1, S, 24, 128), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, S, 8, 128), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, S, 8, 128), generator=gen, device="cuda").to(dt)
        got = fa.flash_attention(q, k, v, causal=True, **kw)
        want = flash_attention_ref(q, k, v, causal=True, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        log(f"flash_attention S={S} {dtype} {kw or 'causal'}: "
            f"max_abs_err={err:.3e} tol={tol:.0e}")
        if not (err <= tol and math.isfinite(err)):
            raise SystemExit(f"flash_attention S={S} {dtype} {kw} disagrees "
                             f"with its plain version")
        if dtype == "bfloat16":
            worst = max(worst, err)
        if dtype == "bfloat16" and not kw:
            ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps)
            plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v),
                               max(reps // 4, 3))
            qh = q.transpose(1, 2)
            kh = k.repeat_interleave(3, dim=2).transpose(1, 2)
            vh = v.repeat_interleave(3, dim=2).transpose(1, 2)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), reps)
            es = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * es
            flops = 4 * 128 * 24 * S * (S + 1) // 2
            b_ms, b_by = bound(nbytes, flops, dtype)
            timing[S] = (ms, plain_ms, lib_ms, b_ms, b_by)
            log(f"flash_attention timing S={S} (Hq=24 Hkv=8 D=128 bf16 "
                f"causal): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    ms, plain_ms, lib_ms, b_ms, b_by = timing[1024]
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    return results


# ---------------------------------------------------------------------------
# phase 3: serving full-width minitron-4b through the decode engine
# ---------------------------------------------------------------------------

def run_serving_phase(torch, model, params):
    import numpy as np

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.workloads.decode import DecodeEngine, ServeConfig

    cfg = model.cfg
    scfg = ServeConfig(max_slots=8, max_len=2048, eos_id=-1,
                       use_kernels=True)
    # warm-up on its own engine: cuBLAS handles, allocator pools
    warm = DecodeEngine(model, params, scfg)
    warm.submit(np.arange(1, 65), max_new_tokens=4)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    plens = rng.integers(100, 1001, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)) for n in plens]
    new = 32

    def serve(engine):
        t0 = time.perf_counter()
        for p in prompts:
            engine.submit(p, max_new_tokens=new)
        step_s = []
        while engine.has_work:
            s0 = time.perf_counter()
            engine.step()
            step_s.append(time.perf_counter() - s0)
            require(len(step_s) <= 1000, "serving did not finish")
        torch.cuda.synchronize()
        return step_s, time.perf_counter() - t0

    engine = DecodeEngine(model, params, scfg)
    rd.launches = 0
    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_s, wall = serve(engine)
    launches = {"ragged_decode": rd.launches, "flash_attention": fa.launches}
    reg = engine._obs.registry
    prefill_h = reg.histogram_at("prefill_s")
    decode_steps = reg.histogram_at("decode_step_s").count
    prefills = prefill_h.count
    results = engine.results()
    toks = sum(len(t) for t in results.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_layers
    log(f"serving: prompts {plens.tolist()}, {new} new tokens each, "
        f"{prefills} prefills, {decode_steps} decode steps, launches "
        f"{launches}")
    require(prefills == 8, f"{prefills} prefills, want 8")
    require(launches["ragged_decode"] >= L * decode_steps > 0,
            f"decode kernel launched {launches} for {decode_steps} steps")
    require(launches["flash_attention"] >= L * prefills,
            f"prefill kernel launched {launches} for {prefills} prefills")
    require(len(results) == 8 and all(len(t) == new
                                      for t in results.values()),
            f"streams incomplete: {[len(t) for t in results.values()]}")
    require(all(0 <= x < cfg.vocab_size for t in results.values()
                for x in t), "token out of the vocabulary")
    # step 0 admits and prefills all 8 requests; the rest are decode steps
    decode_ms = sorted(s * 1e3 for s in step_s[1:])
    p50 = decode_ms[len(decode_ms) // 2]
    log(f"serving: prefill ms per request mean "
        f"{prefill_h.mean * 1e3:.2f} (min {prefill_h.min * 1e3:.2f}, max "
        f"{prefill_h.max * 1e3:.2f}); decode ms per step p50 {p50:.3f}; "
        f"{toks} tokens in {wall:.3f} s = {toks / wall:.1f} tokens/s; "
        f"peak memory {peak_gib:.2f} GiB")

    # the same workload again under torch.profiler (device activity only):
    # kernel time by kind against the unprofiled wall gives the idle share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(DecodeEngine(model, params, scfg))
    per_kernel = {}
    for ev in prof.key_averages():
        # only kernel events are traced, so each one's device time counts
        us = (getattr(ev, "self_device_time_total", 0.0)
              or getattr(ev, "device_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3
    kinds = {"ragged_decode": 0.0, "flash_attention": 0.0,
             "matmul (cuBLAS)": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        low = name.lower()
        kind = next((k for k in ("ragged_decode", "flash_attention")
                     if k in low), None)
        if kind is None:
            kind = "matmul (cuBLAS)" if any(t in low for t in (
                "gemm", "gemv", "nvjet", "xmma", "cutlass")) else "other"
        kinds[kind] += ms
    busy = sum(kinds.values())
    if busy > 0:
        log(f"serving profile: device kernel time {busy:.1f} ms of the "
            f"unprofiled {wall * 1e3:.1f} ms wall (busy share "
            f"{busy / (wall * 1e3):.3f}); by kind (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items()))
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        log("serving profile: top kernels (ms): " + "; ".join(
            f"{n[:60]} {ms:.1f}" for n, ms in top))
    else:
        log("serving profile: the profiler recorded no device time "
            "(device busy share not measured)")
    return launches


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path, full width, one short prompt
# ---------------------------------------------------------------------------

def run_reference_check(torch, model, params):
    gen = torch.Generator(device="cuda").manual_seed(2)
    S = 100
    toks = torch.randint(1, model.cfg.vocab_size, (1, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    caches = {kern: model.init_cache(1, S + 8) for kern in (True, False)}
    logits = {}
    for kern, cache in caches.items():
        logits[kern], caches[kern] = model.prefill(
            params, {"tokens": toks}, cache, use_kernels=kern)
    worst = 0.0
    for step in range(5):
        a, b = logits[True].float(), logits[False].float()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        top2 = b.topk(2, dim=-1).values[0]
        margin = (top2[0] - top2[1]).item() / b.abs().max().item()
        same = bool((a.argmax(-1) == b.argmax(-1)).all().item())
        log(f"reference check step {step}: max|dlogit|/max|logit| = "
            f"{rel:.3e} (tol {LOGIT_REL_TOL:.0e}), argmax equal {same}, "
            f"plain top-2 margin {margin:.3e}")
        if not (math.isfinite(rel) and rel <= LOGIT_REL_TOL
                and (same or margin < LOGIT_REL_TOL)):
            raise SystemExit("kernel path disagrees with the plain path")
        worst = max(worst, rel)
        nxt = a.argmax(-1).to(torch.int32)[:, None]
        for kern in (True, False):
            logits[kern], caches[kern] = model.decode_step(
                params, caches[kern], nxt, use_kernels=kern)
    return worst


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} capability "
        f"{torch.cuda.get_device_capability(0)} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    log(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s: {lib.name}")
    build_log = lib.with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  " + line.strip())

    kernels = run_kernel_phase(torch)

    cfg = get_config("minitron-4b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"minitron-4b: {cfg.param_count() / 1e9:.2f} B params, random bf16 "
        f"weights in {time.perf_counter() - t0:.2f} s")
    launches = run_serving_phase(torch, model, params)
    run_reference_check(torch, model, params)

    entries = []
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entries.append({k: entry[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
