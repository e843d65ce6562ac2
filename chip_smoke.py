#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the CUDA version
   and capability, and builds the port's CUDA kernels from this checkout
   into ``build/kernels/``.
2. Kernel phase: each kernel against its plain PyTorch version on the same
   inputs at the serving paths' shapes, with its time, the plain version's,
   one PyTorch library call's as a yardstick where one computes the same
   function, and its bound.  Attention (minitron-4b heads, bf16): ragged
   decode lengths with a dead slot and lengths that are no multiple of the
   tile; prefill lengths 32, 200 and 1024.  Each attention kernel also
   logs its grid (blocks; chunk and splits for ragged decode), its CUDA
   launches per call as the profiler counts them, and its achieved GB/s or
   TFLOP/s beside the card's peak.  Mamba (falcon-mamba-7b widths):
   the decode step for 8 slots with one dead, in bf16 and fp32, and the
   bf16 step by launch under the profiler (each weight product's time,
   TB/s and plan beside ``torch.matmul`` on the same operands, the
   epilogues, the gaps), its launches serialised and overlapped; the
   selective scan against its plain version at S = 1, 37, 200 and 1024,
   its registers and spills from the build log, and its time at S = 128,
   512 and 1024 with its TB/s, exponentials per second against the SFU's
   peak, grid and blocks per SM.
3. Serving phase, minitron-4b: full width (32 layers, random bf16 weights
   from a fixed seed) through ``DecodeEngine`` with the kernels on: 8
   requests of 100-1000 prompt tokens and 32 new tokens each, on four
   fresh engines in turns, decode steps as CUDA graphs (the main path),
   eager, graphs, eager, each warmed by ``warm_compile(None)`` before the
   clock.  Each run logs decode p50, prefill mean, tokens/s, peak memory,
   graph captures on the serving path (0 with graphs), steps on a
   covering bound, the graph pool's bytes and each graph's captured
   launches and replays; the streams must be equal.  Asserts that every
   layer of every prefill and decode step launched its kernel (a replay
   counts its captured launches), compares one step's logits graph
   against eager and the step's time at its exact KV bound against the
   covering one, profiles each way (the whole run, then the decode steps
   alone: device time per step against host time) and checks kernel-path
   logits against the plain path.  A migration phase then resizes an
   engine 8 -> 12 -> 8 slots mid-stream, preempts, evacuates and adopts
   into a second engine: every stream must equal an uninterrupted run's
   and every ragged decode ticket buffer must read zero.
4. Serving phase, falcon-mamba-7b: the same for full width (64 layers)
   through ``SSMEngine`` with ``max_len`` 512, so that prompts past it show
   admission to be slot-bound, profiled once more with the step's launches
   serialised, where each kernel's time is its own; the decode graph's
   edges are counted by kind (the step's launches must be programmatic
   edges).  For three weight seeds the kernel path is checked against the
   plain path on an fp32 copy of the weights, and in bf16 against the
   model's own rounding floor: its distance from the fp32 plain path may
   exceed the bf16 plain path's by a stated margin only.
5. Fabric phase: full-width minitron-4b (``max_len`` 2048) and
   falcon-mamba-7b (``max_len`` 512), random bf16 weights from seeds 0 and
   1, as two tenants of one ``ComposedServer`` on 8 logical CUs (8 slots
   each, the two-stage policy every 4 steps, warm recomposition).  Each
   tenant's 8 prompts of phase 3 land in one burst at a step drawn from
   numpy seed 0, 32 new tokens each; once minitron is half done, ``unify``
   gives it the card.  Logs every recomposition event, graph captures on
   the serving path after warming (must be 0), per tenant tokens/s, decode
   p50 (host, and on the device: its stream) and TTFT p50/p99, the
   prediction ledger (Stage 1's per-token cost against the measured one,
   per design key), peak memory and the launches of the four serving
   kernels inside the fabric (each must launch).  Requires a
   policy-driven recomposition and the unify, and each tenant's streams
   equal to a lone engine's on the same requests and weights, but where
   the lone path's top-2 margin is under ``ARGMAX_MARGIN`` (counted and
   logged).  Then the run again under the profiler: the busy share.
6. Paper phase.  The filco_mm sweep (the stand-in for Fig. 8's
   single-kernel efficiency): a 2048^3 buffer in fp32 and bf16, valid dims
   at 1/8, 1/4, 1/2 and all of each axis and a ragged (1040, 1032, 2040);
   ``flex_mm`` against its plain version with zeros outside the valid
   region (the output starts as NaN), ``static_mm`` against its plain
   version on the whole buffer, both timed beside the bound (fp32 as
   3xTF32 on the tensor cores, the CUDA-core bound logged beside) and
   ``torch.matmul`` on the valid slices.  Then full-width BERT-128 down
   the paper's path: two-stage DSE, codegen, ``DataPlaneSim`` on the card
   with every CU pass through ``flex_mm``, every layer's DDR result held
   to a plain fp32 walk of the DAG; the device time of the passes under
   the profiler, the host's enqueue of the program, and a per-shape table
   of ``flex_mm`` against ``torch.matmul`` at each pass shape with the
   kernel's plan.  It runs between phases 2 and 3.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device,
outside a checkout of the repository, or when any phase fails.

    python3 chip_smoke.py --scan-baseline DIR [DIR ...]

builds the kernels and only times the selective scan of each other
checkout DIR (its own mamba_scan.cu, e.g. the parent commit unpacked with
``git archive``) beside this checkout's, in turns on one card.
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
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
F32_FLOPS = 67e12                  # fp32 outside the tensor cores
# exponentials on the special-function units: 16 per clock per SM at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the H100 SXM's 1980 MHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# exponentials evaluated beside them on the FP32 pipe (128 lanes per SM),
# as range reduction plus a polynomial: about 8 FP32 instructions each.
# The bound counts both, so that it is the least time; the SFU-only figure
# is logged beside it
FMA_EXP_PER_S = 132 * 128 * 1.98e9 / 8
# bf16 kernel vs plain version: outputs are O(1) weighted means of bf16
# values; the two round p and the running sums at different points, so
# they may differ by a few bf16 ulps (2**-8 relative).  fp32: summation
# order only.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# full-depth logits, kernel path vs plain path: bf16 rounding at different
# points compounds over minitron's 32 layers; bound relative to the largest
# |logit|.
LOGIT_REL_TOL = 5e-2
# falcon-mamba-7b in bf16 is held to its own rounding floor, measured in
# the same run on the same weights: the kernel path's distance from the
# fp32 plain path may exceed the bf16 plain path's distance from it by at
# most this share.  Both are bf16 roundings at the same points, differing
# in summation order only, so their distances from fp32 are two draws from
# one spread (the floor moved by +-8% from step to step on an H100).
SSM_FLOOR_MARGIN = 0.25
# a path's argmax may differ from its reference's only where the
# reference's top-2 margin, relative to its largest |logit|, is below this
ARGMAX_MARGIN = 5e-2
# fp32: summation order only, carried through 64 layers
FP32_LOGIT_REL_TOL = 1e-3
# weight seeds of the falcon-mamba-7b reference checks; seed 0 is the
# served model
SSM_CHECK_SEEDS = (0, 1, 2)
# the filco_mm sweep: one buffer, valid dims at these fractions of each
# axis, and a ragged shape whose edges cut every tile
SWEEP_BUF = 2048
SWEEP_FRACS = (8, 4, 2, 1)
SWEEP_RAGGED = (1040, 1032, 2040)
PAPER_WORKLOAD = "BERT-128"
MAMBA_ORDER = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
               "dt_bias", "A_log", "D", "out_proj")


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
    the serving path finds its inputs cold (weights pass between layers).

    The timed launches queue behind a sleep on the stream that outlasts the
    host's enqueue of all of them, so the events time the device's work:
    a call whose host side (Python, allocations, launches) is slower than
    its kernels would otherwise time the host.  A call of more launches
    than the queue holds (a plain version of thousands of small kernels)
    still waits on the host.  The host's enqueue time of one call is
    logged beside."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"  (host enqueue of one call {host_s * 1e3:.4f} ms)")
    # spin long enough at the H100's top clock of 1.98 GHz
    torch.cuda._sleep(int((reps * (host_s + 2e-4) + 5e-3) * 1.98e9))
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


def bound(nbytes: float, flops: float, dtype: str, exps: float = 0.0,
          tf32x3: bool = False):
    """Least time in ms for ``nbytes`` of traffic, ``flops`` at the peak of
    ``dtype`` and ``exps`` exponentials on the special-function units and
    the FP32 pipe together, and which of bytes or operations binds.  With
    ``tf32x3`` an fp32 product is three TF32 tensor-core products (the
    filco_mm kernel's fp32 arithmetic): 3 x ``flops`` at the TF32 peak."""
    peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
    if tf32x3 and dtype == "float32":
        flops, peak = 3 * flops, TF32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / peak, exps / (SFU_EXP_PER_S + FMA_EXP_PER_S))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def agree(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol |want| everywhere, and got finite: a bf16
    value that rounds to the neighbouring bf16 moves by 2**-8 of itself."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all().item()
                and g.isfinite().all().item())


def _counter(name: str):
    from repro_torch.kernels.launches import COUNTERS
    return COUNTERS[name]


def reset_counts(names) -> None:
    for name in names:
        setattr(*_counter(name), 0)


def read_counts(names):
    return {name: getattr(*_counter(name)) for name in names}


def cuda_launches(torch, fn):
    """The device kernels one call of ``fn`` launches, by name, as the
    profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            kinds[name] = kinds.get(name, 0) + 1
    return kinds


# the Mamba step's launches in call order, and which of them are the four
# weight products
STEP_LAUNCHES = ("in_proj", "conv", "x_proj", "dbc", "dt_proj", "ssm",
                 "out_proj", "out")
STEP_PRODUCTS = ("in_proj", "x_proj", "dt_proj", "out_proj")


def step_breakdown(torch, fn, reps: int = 10, clean: bool = False):
    """Device time of each of the Mamba step's launches, from
    ``torch.profiler`` over ``reps`` calls of ``fn``, each after a write
    that evicts the L2 (as ``time_ms`` does) or, with ``clean``, a read
    that evicts it and leaves no dirty line to write back (as serving
    finds it: the previous layer's weights pass through the L2 clean), all
    queued behind a sleep so that the host's enqueue does not open gaps.
    Returns (mean ms of each launch in call order, mean span ms from the
    first launch's start to the last one's end); the span less the
    launches' sum is the device's gaps between them (negative where
    launches overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    evict = (lambda: flush.max()) if clean else flush.zero_
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evict()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int((reps * (host_s + 2e-4) + 5e-3) * 1.98e9))
        for _ in range(reps):
            evict()
            fn()
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA
                  and "mamba_step" in ev.name),
                 key=lambda ev: ev.time_range.start)
    n = len(STEP_LAUNCHES)
    require(len(evs) == reps * n,
            f"step profile: {len(evs)} launches for {reps} calls of {n}")
    per, span = [0.0] * n, 0.0
    for c in range(reps):
        call = evs[c * n:(c + 1) * n]
        for i, ev in enumerate(call):
            per[i] += (ev.time_range.end - ev.time_range.start) / 1e3 / reps
        span += (max(ev.time_range.end for ev in call)
                 - call[0].time_range.start) / 1e3 / reps
    return per, span


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
    T = k.shape[1]
    chunk, n_split = rd.split_plan(
        B, Hkv, T, torch.cuda.get_device_properties(0).multi_processor_count)
    items = Hkv * sum(-(-n // chunk) if a else 1 for n, a in zip(lengths, live))
    kinds = cuda_launches(torch, lambda: rd.ragged_decode_attention(
        q, k, v, lens, live=livet))
    log(f"ragged_decode timing (B={B} T={T} Hq={Hq} Hkv={Hkv} "
        f"D={D} bf16, live KV rows {live_len}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); {nbytes / ms / 1e6:.1f} GB/s (bound "
        f"{HBM_BYTES_PER_S / 1e9:.0f}), sdpa {nbytes / lib_ms / 1e6:.1f} "
        f"GB/s of the same bytes")
    log(f"ragged_decode grid: chunk {chunk} rows, {n_split} splits, "
        f"{B * Hkv * n_split} blocks launched ({items} with work; B*Hkv = "
        f"{B * Hkv}); CUDA launches per call {sum(kinds.values())} {kinds}")
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
            kinds = cuda_launches(torch, lambda: fa.flash_attention(q, k, v))
            # four sequences per launch: the time per sequence against B = 1
            # shows how much the longest causal chain costs at B = 1
            q4, k4, v4 = (t.expand(4, -1, -1, -1).contiguous()
                          for t in (q, k, v))
            ms4 = time_ms(torch, lambda: fa.flash_attention(q4, k4, v4),
                          max(reps // 2, 3)) / 4
            log(f"flash_attention timing S={S} (Hq=24 Hkv=8 D=128 bf16 "
                f"causal): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                f"{flops / ms / 1e9:.1f} TFLOP/s (bound "
                f"{BF16_FLOPS / 1e12:.0f}), sdpa {flops / lib_ms / 1e9:.1f}; "
                f"{fa.grid(1, S, 24)} blocks, CUDA launches per call "
                f"{sum(kinds.values())} {kinds}; B=4: {ms4:.4f} ms per "
                f"sequence")
    ms, plain_ms, lib_ms, b_ms, b_by = timing[1024]
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    return results


def log_step_breakdown(torch, gen, x1, conv, h, args, live, reps):
    """The bf16 step's device time by launch at falcon-mamba-7b widths,
    with its launches serialised and overlapped: each weight product's
    time, bytes, TB/s and plan beside ``torch.matmul`` on the same
    (B, K) @ (K, N) operands (its yardstick; the port never calls it),
    the four epilogues' time, and the gaps between launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import ops as ms
    weights = dict(zip(STEP_PRODUCTS, (args[0], args[3], args[4], args[8])))
    B = x1.shape[0]
    sms = _build.sm_count(0)
    lib = {}
    for name, w in weights.items():
        xb = torch.randn((B, w.shape[0]), generator=gen,
                         device="cuda").to(w.dtype)
        lib[name] = time_ms(torch, lambda: xb @ w, reps)
    call = lambda: ms.mamba_step(x1, conv, h, *args, live=live)
    for ov, clean in ((False, False), (False, True), (True, False)):
        ms.overlap = ov
        events = ("" if clean else f"; step by CUDA events after a write "
                  f"{time_ms(torch, call, reps):.4f} ms")
        per, span = step_breakdown(torch, call, clean=clean)
        t = dict(zip(STEP_LAUNCHES, per))
        parts = []
        for name, w in weights.items():
            nbytes = w.numel() * w.element_size()
            p = ms.plan(B, *w.shape, sms)
            parts.append(
                f"{name} ({w.shape[0]}x{w.shape[1]}) {t[name]:.4f} ms for "
                f"{nbytes / 1e6:.1f} MB = {nbytes / t[name] / 1e9:.2f} TB/s "
                f"[{p.splits} splits, {p.items} items, {p.grid} blocks], "
                f"torch.matmul {lib[name]:.4f} ms = "
                f"{nbytes / lib[name] / 1e9:.2f} TB/s")
        prod = sum(t[n] for n in STEP_PRODUCTS)
        epi = sum(v for n, v in t.items() if n not in STEP_PRODUCTS)
        mode = (("overlapped" if ov else "serialised") + ", L2 "
                + ("evicted clean by a read" if clean else "flushed by a "
                   "write"))
        log(f"mamba_step by launch, {mode} (bf16, falcon-mamba-7b widths, "
            f"one layer, torch.profiler; overlapped launches' times include "
            f"their wait): " + "; ".join(parts))
        log(f"mamba_step by launch, {mode}: products {prod:.4f} ms, "
            f"epilogues {epi:.4f} ms (" + ", ".join(
                f"{n} {v:.4f}" for n, v in t.items()
                if n not in STEP_PRODUCTS)
            + f"), span first start to last end {span:.4f} ms, gaps (span "
            f"less the launches' sum) {span - prod - epi:.4f} ms{events}")
    ms.overlap = True


SCAN_SWEEP = (128, 512, 1024)      # prompt lengths the scan is timed at


def scan_params(torch, d_in: int, N: int):
    """A_log as falcon-mamba-7b initialises it (log 1..N per channel) and
    D = 1."""
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device="cuda")).expand(d_in, N).contiguous()
    return a_log, torch.ones(d_in, dtype=torch.float32, device="cuda")


def scan_inputs(torch, gen, S: int, d_in: int, R: int, N: int, dtype):
    """x, dt (softplus'd) and B, C as the prefill hands them over: B and C
    strided views of one (1, S, R + 2N) dbc tensor."""
    from repro_torch.kernels.mamba_scan.ref import softplus
    x = torch.randn((1, S, d_in), generator=gen, device="cuda").to(dtype)
    delta = softplus(torch.randn((1, S, d_in), generator=gen,
                                 device="cuda") - 4.0)
    dbc = torch.randn((1, S, R + 2 * N), generator=gen,
                      device="cuda").to(dtype)
    return x, delta, dbc[..., R:R + N], dbc[..., R + N:]


def scan_work(S: int, d_in: int, N: int, es: int):
    """(bytes, exponentials, flops) of one B = 1 scan: x, dt, B, C, A_log
    and D read once, y and the last state written once; one exponential
    per state-step and per A; six flops per state-step, three per output."""
    n_io = S * d_in
    nbytes = (n_io * es + n_io * 4 + 2 * S * N * es + 4 * d_in * (N + 1)
              + n_io * 4 + 4 * d_in * N)
    return nbytes, n_io * N + d_in * N, 6 * n_io * N + 3 * n_io


def scan_sweep(torch, gen, d_in: int, R: int, N: int, reps: int,
               label: str = "mamba_scan", show_plan: bool = True):
    """Times the scan at B = 1, bf16, for each S of ``SCAN_SWEEP`` and logs
    its bytes per second and exponentials per second beside the SFU's peak,
    its plan (grid, blocks per SM) and its bound.  Returns {S: (ms, bound
    ms, bound_by)}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import ops as ms
    a_log, d_vec = scan_params(torch, d_in, N)
    p = ms.scan_plan(1, d_in, N, _build.sm_count(0))
    out = {}
    for S in SCAN_SWEEP:
        x, delta, bm, cm = scan_inputs(torch, gen, S, d_in, R, N,
                                       torch.bfloat16)
        t = time_ms(torch, lambda: ms.mamba_scan(x, delta, bm, cm, a_log,
                                                 d_vec), reps)
        nbytes, exps, flops = scan_work(S, d_in, N, 2)
        b_ms, b_by = bound(nbytes, flops, "float32", exps=exps)
        log(f"{label} S={S} (B=1, d_in={d_in}, N={N}, bf16): {t:.4f} ms, "
            f"{nbytes / t / 1e9:.3f} TB/s of {nbytes / 1e6:.1f} MB, "
            f"{exps / t / 1e9:.3f} T exp/s = "
            f"{exps / t * 1e3 / SFU_EXP_PER_S:.3f} of the SFU peak; bound "
            f"{b_ms:.4f} ms ({b_by}; bytes "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, SFU alone "
            f"{exps / SFU_EXP_PER_S * 1e3:.4f} ms)" + (
                f"; plan {p.channels} channels per block, grid {p.grid} "
                f"blocks of {p.channels * N // ms._SCAN_STATES} scanning "
                f"threads and a "
                f"producer warp, at most {p.per_sm} per SM"
                if show_plan else ""))
        out[S] = (t, b_ms, b_by)
        del x, delta, bm, cm
    return out


def log_scan_build(text: str = None, label: str = "mamba_scan") -> None:
    """The scan kernels' registers and spills, from ptxas in the build log
    (or in ``text``)."""
    from repro_torch.kernels import _build
    if text is None:
        path = _build.library_path().with_suffix(".log")
        if not path.exists():
            return
        text = path.read_text()
    entry, spill = None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if "mamba_scan_kernel" in name else None
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "registers" in line:
            tmpl = entry[entry.index("mamba_scan_kernel") + 17:]
            log(f"{label} build {tmpl}: {line.split(':', 1)[1].strip()}; "
                f"{spill}")
            entry = None


def build_other_scan(checkout: Path):
    """Another checkout's scan (its mamba_scan.cu and common.cu, built into
    build/other/<name>/) as a function with this checkout's C signature;
    a scan whose C function takes no channels per block ignores them."""
    import ctypes
    from repro_torch.kernels import _build
    kdir = checkout.resolve() / "src" / "repro_torch" / "kernels"
    src = kdir / "mamba_scan" / "csrc" / "mamba_scan.cu"
    lib_path = ROOT / "build" / "other" / checkout.name / "libmamba_scan.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
                          "-shared", "-o", str(lib_path), str(src),
                          str(kdir / "common" / "csrc" / "common.cu")],
                         check=True, capture_output=True, text=True)
    log_scan_build(out.stdout + out.stderr, str(checkout))
    fn = ctypes.CDLL(str(lib_path)).mamba_scan
    fn.restype = ctypes.c_int
    planned = "int channels, int dtype" in src.read_text()
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 8 + [ctypes.c_int] * (
                       2 if planned else 1) + [ctypes.c_void_p])
    return fn if planned else (lambda *a: fn(*a[:20], *a[21:]))


def run_scan_compare(torch, others, reps: int = 20):
    """``--scan-baseline DIR [DIR ...]``: the scan of each other checkout
    (DIR: its root) beside this checkout's, timed by ``scan_sweep`` on one
    card in turns (the others, this checkout twice, the others), each
    first compared with the plain version at S = 1024 (this checkout's
    must agree)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.models import ssm as S
    orig = ms._scan_fn
    new = orig()
    d_in, R, N, _ = S.dims(get_config("falcon-mamba-7b"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    a_log, d_vec = scan_params(torch, d_in, N)
    x, delta, bm, cm = scan_inputs(torch, gen, 1024, d_in, R, N,
                                   torch.bfloat16)
    want = mamba_scan_ref(x, delta, bm, cm, a_log, d_vec)
    olds = [(str(o), build_other_scan(o)) for o in others]
    this = [("this checkout", new)]
    try:
        for label, fn in olds + this + this + olds:
            ms._scan_fn = lambda fn=fn: fn
            got = ms.mamba_scan(x, delta, bm, cm, a_log, d_vec)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            ok = all(agree(g, w, TOL["float32"]) for g, w in zip(got, want))
            # another checkout may be a probe that computes something else
            require(ok or fn is not new,
                    f"{label}: scan disagrees with its plain version")
            log(f"{label}: S=1024 max_abs_err {err:.3e}, agrees {ok}")
            scan_sweep(torch, gen, d_in, R, N, reps, label=label,
                       show_plan=fn is new)
    finally:
        ms._scan_fn = orig


def run_ssm_kernel_phase(torch, reps: int = 20):
    """The Mamba step and selective-scan kernels against their plain
    versions at falcon-mamba-7b widths (d_model 4096, d_in 8192, N 16,
    dt_rank 256, conv width 4)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_ref,
                                                    mamba_step_ref)
    from repro_torch.models import ssm as S

    cfg = get_config("falcon-mamba-7b")
    d_in, R, N, w = S.dims(cfg)
    d_model = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}

    # -- decode step: 8 slots, slot 5 dead ----------------------------------
    B, dead = 8, 5
    live = torch.ones(B, dtype=torch.bool, device="cuda")
    live[dead] = False
    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        p = S.mamba_init(gen, cfg, dtype=dt, device="cuda")
        args = [p[k] for k in MAMBA_ORDER]
        x1 = torch.randn((B, 1, d_model), generator=gen, device="cuda").to(dt)
        conv0 = torch.randn((B, w - 1, d_in), generator=gen,
                            device="cuda").to(dt)
        h0 = torch.randn((B, d_in, N), generator=gen, device="cuda") * 0.5
        conv, h = conv0.clone(), h0.clone()
        out = ms.mamba_step(x1, conv, h, *args, live=live)
        want = mamba_step_ref(x1, conv0, h0, *args, live=live)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        errs = [(g.float() - r.float()).abs().max().item()
                for g, r in zip((out, conv, h), want)]
        ok = all(agree(g, r, tol) for g, r in zip((out, conv, h), want))
        dead_ok = bool((out[dead] == 0).all().item()
                       and torch.equal(conv[dead], conv0[dead])
                       and torch.equal(h[dead], h0[dead]))
        log(f"mamba_step {dtype} B={B} (slot {dead} dead): max_abs_err out "
            f"{errs[0]:.3e} conv {errs[1]:.3e} h {errs[2]:.3e}, tol {tol:.0e} "
            f"abs + rel; dead row zero and bit-unchanged {dead_ok}")
        if not (ok and dead_ok):
            raise SystemExit(f"mamba_step {dtype} disagrees with its plain "
                             f"version")
        if dtype == "bfloat16":
            worst = max(errs)
            ms_ = time_ms(torch, lambda: ms.mamba_step(x1, conv, h, *args,
                                                       live=live), reps)
            plain_ms = time_ms(torch, lambda: mamba_step_ref(
                x1, conv, h, *args, live=live), max(reps // 4, 3))
            nlive = int(live.sum().item())
            es = x1.element_size()
            products = (d_model * 2 * d_in + d_in * (R + 2 * N) + R * d_in
                        + d_in * d_model)
            fp32_params = w * d_in + 3 * d_in + d_in * N
            state = (w - 1) * d_in * es + d_in * N * 4
            nbytes = (products * es + fp32_params * 4 + 2 * B * d_model * es
                      + 2 * nlive * state + 4 * B)
            flops = 2 * nlive * products
            b_ms, b_by = bound(nbytes, flops, dtype,
                               exps=nlive * d_in * (N + 3))
            log(f"mamba_step timing (falcon-mamba-7b widths, bf16, {nlive} "
                f"live of {B} slots, one layer): kernel {ms_:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                f"{nbytes / 1e6:.1f} MB); library none: no single PyTorch "
                f"call computes the Mamba step")
            results["mamba_step"] = dict(
                name="mamba_step", route="cuda",
                source="src/repro_torch/kernels/mamba_scan/csrc/"
                       "mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan/kernel.py:107",
                ms=ms_, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
            log_step_breakdown(torch, gen, x1, conv, h, args, live, reps)
        del p, args
    results["mamba_step"]["max_abs_err"] = worst

    # -- prefill selective scan --------------------------------------------
    worst = 0.0
    a_log, d_vec = scan_params(torch, d_in, N)
    for S_len, dtype in ((1, "bfloat16"), (37, "bfloat16"), (200, "bfloat16"),
                         (1024, "bfloat16"), (200, "float32")):
        x, delta, bm, cm = scan_inputs(torch, gen, S_len, d_in, R, N,
                                       getattr(torch, dtype))
        y, h_last = ms.mamba_scan(x, delta, bm, cm, a_log, d_vec)
        want_y, want_h = mamba_scan_ref(x, delta, bm, cm, a_log, d_vec)
        torch.cuda.synchronize()
        tol = TOL["float32"]
        err_y = (y - want_y).abs().max().item()
        err_h = (h_last - want_h).abs().max().item()
        log(f"mamba_scan S={S_len} {dtype} inputs (y, h fp32): max_abs_err "
            f"y {err_y:.3e} h {err_h:.3e}, tol {tol:.0e} abs + rel")
        if not (agree(y, want_y, tol) and agree(h_last, want_h, tol)):
            raise SystemExit(f"mamba_scan S={S_len} {dtype} disagrees with "
                             f"its plain version")
        worst = max(worst, err_y, err_h)
        if S_len == 1024:
            plain_ms = time_ms(torch, lambda: mamba_scan_ref(
                x, delta, bm, cm, a_log, d_vec), 3)
        del x, delta, bm, cm, y, h_last, want_y, want_h
    log_scan_build()
    sweep = scan_sweep(torch, gen, d_in, R, N, reps)
    ms_, b_ms, b_by = sweep[1024]
    log(f"mamba_scan timing (S=1024, B=1, d_in={d_in}, N={N}, bf16 x/B/C): "
        f"kernel {ms_:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); library none: no single PyTorch call computes the "
        f"selective scan")
    results["mamba_scan"] = dict(
        name="mamba_scan", route="cuda",
        source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan/kernel.py:165",
        ms=ms_, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    results["mamba_scan"]["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 3 and 4: serving a full-width model through its engine
# ---------------------------------------------------------------------------

def serve(torch, engine, prompts, new):
    """Submit ``prompts`` (``new`` tokens each) and step ``engine`` to the
    end.  Returns (seconds of each step, wall seconds, streams in the
    order of submission)."""
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    step_s = []
    while engine.has_work:
        s0 = time.perf_counter()
        engine.step()
        step_s.append(time.perf_counter() - s0)
        require(len(step_s) <= 1000, "serving did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = engine.results()
    return step_s, wall, [results[r] for r in rids]


def make_engine(torch, engine_cls, model, params, scfg, graphs: bool):
    """A fresh engine whose decode steps are CUDA graphs (``graphs``) or
    eager, warmed by ``warm_compile(None)``.  Returns (engine, builds,
    seconds the warm-up took)."""
    from repro_torch.workloads import decode
    decode.graphs = graphs
    try:
        engine = engine_cls(model, params, scfg)
        t0 = time.perf_counter()
        built = engine.warm_compile(None)
        torch.cuda.synchronize()
    finally:
        decode.graphs = True
    return engine, built, time.perf_counter() - t0


def graph_steps(engine):
    from repro_torch.workloads.compile_cache import GraphStep
    return [e for e in engine._exec._exe.values() if isinstance(e, GraphStep)]


def serving_run(torch, engine_cls, model, params, scfg, prompts, new,
                kernels, graphs: bool):
    """One measured run on a fresh engine, warmed before the clock; its
    numbers, its launch counts and its streams."""
    import gc
    gc.collect()                # the last run's engine and its graphs
    engine, built, warm_s = make_engine(torch, engine_cls, model, params,
                                        scfg, graphs)
    captures, covering = engine.graph_captures, engine.covering_steps
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    step_s, wall, streams = serve(torch, engine, prompts, new)
    launches = read_counts(kernels)
    reg = engine._obs.registry
    prefill_h = reg.histogram_at("prefill_s")
    # step 0 admits and prefills all requests; the rest are decode steps
    decode_ms = sorted(s * 1e3 for s in step_s[1:])
    toks = sum(len(t) for t in streams)
    run = {
        "label": "graphs" if graphs else "eager",
        "engine": type(engine).__name__, "streams": streams,
        "launches": launches, "wall": wall,
        "decode_wall": sum(step_s[1:]), "tokens": toks,
        "tokens_s": toks / wall,
        "p50": decode_ms[len(decode_ms) // 2],
        "prefill": (prefill_h.mean * 1e3, prefill_h.min * 1e3,
                    prefill_h.max * 1e3),
        "prefills": prefill_h.count,
        "decode_steps": reg.histogram_at("decode_step_s").count,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "warm": (built, warm_s),
        "path_captures": engine.graph_captures - captures,
        "covering": engine.covering_steps - covering,
        "pool_mib": engine.graph_pool_bytes() / 2**20,
        "graphs": [(g.launches, g.replays) for g in graph_steps(engine)],
    }
    return run


def filled_engine(torch, engine_cls, model, params, scfg, S: int,
                  max_len: int):
    """An engine of 8 slots whose pool holds 8 prefilled S-token prompts
    (random, seed 3), and one more random token per slot."""
    import dataclasses
    cfg = dataclasses.replace(scfg, max_slots=8, max_len=max_len)
    engine = engine_cls(model, params, cfg)
    # the pool was made on the engine's stream; these writes are on this
    # thread's stream
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda").manual_seed(3)
    V = model.cfg.vocab_size
    toks = torch.randint(1, V, (8, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    _, filled = model.prefill(params, {"tokens": toks}, engine.cache,
                              use_kernels=True)
    engine.cache["pos"].copy_(filled["pos"])
    x = torch.randint(1, V, (8, 1), generator=gen, device="cuda",
                      dtype=torch.int32)
    torch.cuda.synchronize()
    return engine, x


def covering_cost(torch, engine_cls, model, params, scfg):
    """The price of dispatching on a covering bound: one decode step of 8
    slots at 900 live rows, captured at its exact bound (928) and at full
    capacity (the covering bound serving uses), each timed over 20
    replays (L2 flushed before each, as ``time_ms`` does)."""
    engine, _ = filled_engine(torch, engine_cls, model, params, scfg, 900,
                              scfg.max_len)
    pool = engine._pool
    pool.inputs[2].fill_(1)                     # every slot live
    times = {}
    for bounds in ((928,), (scfg.max_len,)):
        step = engine._build_decode(pool, bounds)
        torch.cuda.synchronize()        # the capture ran on engine streams
        times[bounds] = time_ms(torch, step, reps=20)
    log(f"covering bound cost {model.cfg.name}: a decode step of 8 slots "
        f"at 900 rows, graph at the exact bound (928,) {times[(928,)]:.4f} "
        f"ms, at the covering bound ({scfg.max_len},) "
        f"{times[(scfg.max_len,)]:.4f} ms ({card_line()})")


def graph_logits_check(torch, engine_cls, model, params, scfg):
    """One decode step of 8 live slots (100-token prompts), eager and as
    a captured graph on the same state: the largest |logit| difference
    (expected 0: the graph replays the eager step's kernels)."""
    engine, x = filled_engine(torch, engine_cls, model, params, scfg, 100,
                              256)
    live = torch.ones(8, dtype=torch.bool, device="cuda")
    kv_bound = None if model.cfg.attention_free else 128
    pool = engine._pool

    def step():
        return model.decode_step(params, pool.cache, x, use_kernels=True,
                                 kv_bound=kv_bound, live_mask=live)[0]

    graph = engine._capture(pool, step)
    torch.cuda.synchronize()            # the capture ran on engine streams
    state = engine._step_state(pool)
    saved = [t.clone() for t in state]
    eager = step().float()
    for t, s in zip(state, saved):
        t.copy_(s)
    replay = graph().float()
    torch.cuda.synchronize()
    diff = (eager - replay).abs().max().item()
    require(math.isfinite(diff) and bool(replay.isfinite().all().item()),
            "graph logits are not finite")
    return diff


def graph_edge_kinds(graph):
    """The edges of a captured graph whose template was kept, by kind, as
    the driver reads them (``cuGraphGetEdges_v2``): "programmatic" (the
    launch after may start before the one before ends: programmatic
    dependent launch) and "full"."""
    import ctypes

    class Edge(ctypes.Structure):
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetEdges_v2(handle, None, None, None, ctypes.byref(n))
    require(err == 0, f"cuGraphGetEdges_v2 failed: {err}")
    src = (ctypes.c_void_p * n.value)()
    dst = (ctypes.c_void_p * n.value)()
    data = (Edge * n.value)()
    err = cu.cuGraphGetEdges_v2(handle, src, dst, data, ctypes.byref(n))
    require(err == 0, f"cuGraphGetEdges_v2 failed: {err}")
    kinds = {"programmatic": 0, "full": 0}
    for e in data:      # type 1: CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC
        kinds["programmatic" if e.type == 1 else "full"] += 1
    return kinds


def pdl_edge_check(torch, engine_cls, model, params, scfg):
    """Capture the decode step of ``engine_cls`` with its graph's template
    kept and count the graph's edges by kind: each layer's Mamba step is
    eight launches, each one a programmatic dependent of the launch
    before, so at least 7 programmatic edges per layer must be there."""
    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls):
            return super().__new__(cls, keep_graph=True)

        def __init__(self):
            super().__init__(keep_graph=True)

    torch.cuda.CUDAGraph = Kept
    try:
        engine, _, _ = make_engine(torch, engine_cls, model, params, scfg,
                                   True)
    finally:
        torch.cuda.CUDAGraph = base
    (step,) = graph_steps(engine)
    kinds = graph_edge_kinds(step.graph)
    L = model.cfg.num_layers
    log(f"graph edges of {model.cfg.name}'s decode step ({step.launches} "
        f"captured): {kinds}; want at least 7 programmatic per layer "
        f"({7 * L})")
    require(kinds["programmatic"] >= 7 * L,
            "the Mamba step's launches did not capture as programmatic "
            "edges")


def run_serving_phase(torch, model, params, engine_cls, scfg, *, per_step,
                      per_prefill):
    """8 requests of 100-1000 prompt tokens, 32 new tokens each, through
    ``engine_cls`` on fresh engines, warmed by ``warm_compile(None)``
    before the clock: decode steps as CUDA graphs (the main path), then
    eagerly; the two runs' streams must be equal token for token.
    ``per_step`` / ``per_prefill`` name the kernels every layer launches
    on every decode step / prefill.  Then both again under the profiler.
    Returns the graph run's launch counts and streams."""
    cfg = model.cfg
    name = cfg.name
    kernels = (per_step, per_prefill)
    prompts = serving_prompts(cfg)
    new = 32
    # warm-up on its own engine, the same prompts: cuBLAS handles, the
    # allocator's blocks for every prefill shape
    warm = engine_cls(model, params, scfg)
    for p in prompts:
        warm.submit(p, max_new_tokens=2)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()

    # in turns, so that neither way runs on a colder process
    runs = [serving_run(torch, engine_cls, model, params, scfg, prompts,
                        new, kernels, graphs)
            for graphs in (True, False, True, False)]
    L = cfg.num_layers
    card = card_line()
    for run in runs:
        launches = run["launches"]
        steps = run["decode_steps"]
        mean, lo, hi = run["prefill"]
        log(f"serving {name} ({run['engine']}, max_len "
            f"{scfg.max_len}, {run['label']}): prompts "
            f"{[len(p) for p in prompts]}, {new} new tokens each, "
            f"{run['prefills']} prefills, {steps} decode steps, launches "
            f"{launches}")
        log(f"serving {name} {run['label']}: warm_compile built "
            f"{run['warm'][0]} in {run['warm'][1]:.3f} s before the clock; "
            f"graph captures on the serving path {run['path_captures']}; "
            f"steps on a covering bound {run['covering']}; graph pool "
            f"{run['pool_mib']:.1f} MiB; graphs (launches captured, "
            f"replays) {run['graphs']}")
        log(f"serving {name} {run['label']}: prefill ms per request mean "
            f"{mean:.2f} (min {lo:.2f}, max {hi:.2f}); decode ms per step "
            f"p50 {run['p50']:.3f}; {run['tokens']} tokens in "
            f"{run['wall']:.3f} s = {run['tokens_s']:.1f} tokens/s; peak "
            f"memory {run['peak_gib']:.2f} GiB ({card})")
        require(run["prefills"] == 8, f"{run['prefills']} prefills, want 8")
        require(launches[per_step] >= L * steps > 0,
                f"{per_step} launched {launches} for {steps} steps")
        require(launches[per_prefill] >= L * run["prefills"],
                f"{per_prefill} launched {launches} for {run['prefills']} "
                "prefills")
        require(len(run["streams"]) == 8 and all(
            len(t) == new for t in run["streams"]),
            f"streams incomplete: {[len(t) for t in run['streams']]}")
        require(all(0 <= x < cfg.vocab_size for t in run["streams"]
                    for x in t), "token out of the vocabulary")
    for graph, eager in (runs[0:2], runs[2:4]):
        require(graph["path_captures"] == 0,
                f"{graph['path_captures']} graph captures on the serving "
                "path after warm_compile")
        require(bool(graph["graphs"]) and not eager["graphs"],
                "the graph run replayed no graph, or the eager run did")
        replays = sum(r for _, r in graph["graphs"])
        require(replays == graph["decode_steps"],
                f"{replays} graph replays for {graph['decode_steps']} steps")
        require(graph["streams"] == eager["streams"] == runs[0]["streams"],
                f"{name}: graph and eager streams differ")
    diff = graph_logits_check(torch, engine_cls, model, params, scfg)
    log(f"serving {name}: streams of the four runs equal, token for token; "
        f"one decode step's logits, graph vs eager, max |diff| = "
        f"{diff:.3e}")
    if not cfg.attention_free:
        covering_cost(torch, engine_cls, model, params, scfg)
    torch.cuda.empty_cache()

    # the same workload again under torch.profiler (device activity
    # only), each way, on fresh engines warmed before the profiler starts:
    # the whole run, then the decode steps alone (the profiler starts
    # after step 0, which admits and prefills every request)
    def make(graphs, first_step=False):
        def build():
            engine = make_engine(torch, engine_cls, model, params, scfg,
                                 graphs)[0]
            if first_step:
                for p in prompts:
                    engine.submit(p, max_new_tokens=new)
                engine.step()
                torch.cuda.synchronize()
            return engine
        return build

    def rest(engine):
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()

    profiles = []
    for graphs, run in ((True, runs[0]), (False, runs[1])):
        profiles.append((make(graphs), lambda e: serve(torch, e, prompts,
                                                       new),
                         run["label"], run["wall"], None, None))
        profiles.append((make(graphs, True), rest,
                         run["label"] + ", decode steps", run["decode_wall"],
                         None, run["decode_steps"] - 1))
    if per_step == "mamba_step":
        # the step's launches overlap (a kernel starts, then waits on the
        # one before), so its kernels' summed durations count the waits;
        # a replay with them serialised gives each kernel's own time
        profiles.append((make(True), lambda e: serve(torch, e, prompts,
                                                     new),
                         "graphs, launches serialised", runs[0]["wall"],
                         False, None))
    for build, run, label, wall, overlap, steps in profiles:
        profile_serving(torch, build, run, f"{name} {label}", kernels, wall,
                        runs[0]["launches"][per_step], per_step, overlap,
                        per_steps=steps)
    return runs[0]["launches"], runs[0]["streams"]


def serving_prompts(cfg):
    """The serving phases' 8 prompts of 100-1000 tokens, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    plens = rng.integers(100, 1001, size=8)
    return [rng.integers(1, cfg.vocab_size, size=int(n)) for n in plens]


def profile_serving(torch, make, run, name, kernels, wall, steps, per_step,
                    overlap, per_steps=None):
    """Profile ``run(make())`` (device activity only; the engine is made,
    and warmed, before the profiler starts) and log the device time by
    kind, the top kernels, and the busy share of the unprofiled ``wall``:
    the union of the kernels' intervals on the device's timeline, so that
    overlapping launches are counted once.  ``overlap`` (if not None) sets
    the Mamba step's launch mode for the replay, captures included.  With
    ``per_steps`` (the decode steps profiled), also each step's device
    busy time against its host time in the unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mamba_scan import ops as ms
    if overlap is not None:
        ms.overlap = overlap
    try:
        engine = make()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(engine)
    finally:
        ms.overlap = True
    del engine
    per_kernel = {}
    for ev in prof.key_averages():
        # only kernel events are traced, so each one's device time counts
        us = (getattr(ev, "self_device_time_total", 0.0)
              or getattr(ev, "device_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    union /= 1e3
    kinds = dict.fromkeys(kernels + ("matmul (cuBLAS)", "other"), 0.0)
    for kname, t in per_kernel.items():
        low = kname.lower()
        kind = next((k for k in kernels if k in low), None)
        if kind is None:
            kind = "matmul (cuBLAS)" if any(pat in low for pat in (
                "gemm", "gemv", "nvjet", "xmma", "cutlass")) else "other"
        kinds[kind] += t
    busy = sum(kinds.values())
    if busy <= 0:
        log(f"serving {name} profile: the profiler recorded no device time "
            "(device busy share not measured)")
        return
    log(f"serving {name} profile: kernels' summed device time {busy:.1f} ms, "
        f"device busy (union of kernel intervals) {union:.1f} ms of the "
        f"unprofiled {wall * 1e3:.1f} ms wall (busy share "
        f"{union / (wall * 1e3):.3f}); by kind (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items()))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"serving {name} profile: top kernels (ms): " + "; ".join(
        f"{n[:60]} {t:.1f}" for n, t in top))
    if per_steps:
        log(f"serving {name} profile: per decode step, device busy "
            f"{union / per_steps:.3f} ms of {wall * 1e3 / per_steps:.3f} ms "
            f"host (mean over {per_steps} steps); by kind (ms per step): "
            + ", ".join(f"{k} {v / per_steps:.3f}"
                        for k, v in kinds.items()))
    if per_step == "mamba_step":
        prod = sum(t for k, t in per_kernel.items()
                   if "mamba_step_gemm" in k or "mamba_step_mma" in k)
        log(f"serving {name} profile: the step's weight-product kernels "
            f"{prod:.1f} ms of mamba_step's {kinds[per_step]:.1f} ms, "
            f"{prod / max(steps, 1):.4f} ms per call")


# ---------------------------------------------------------------------------
# the serving fabric: two full-width tenants of one composed card
# ---------------------------------------------------------------------------

FABRIC_CUS = 8
# tenant (arch), max_len, weight seed
FABRIC_FLEET = (("minitron-4b", 2048, 0), ("falcon-mamba-7b", 512, 1))
FABRIC_KERNELS = ("ragged_decode", "flash_attention", "mamba_step",
                  "mamba_scan")
FABRIC_NEW = 32


def make_fabric(torch, params=None):
    """The fabric of the phase: the two tenants on ``FABRIC_CUS`` CUs of
    the card, 8 slots each, the two-stage policy deciding every 4 steps,
    warm recomposition; each tenant warmed by ``warm_compile(None)``."""
    from repro_torch.common.platform import H100_SXM, per_cu
    from repro_torch.serve import (AnalyticalPolicy, ComposedServer,
                                   ServeConfig, TenantSpec)
    specs = [TenantSpec(arch, arch, reduced=False, seed=seed,
                        serve=ServeConfig(max_slots=8, max_len=max_len,
                                          eos_id=-1, use_kernels=True))
             for arch, max_len, seed in FABRIC_FLEET]
    srv = ComposedServer(specs, num_cus=FABRIC_CUS, device="cuda",
                         params=params,
                         policy=AnalyticalPolicy(per_cu(H100_SXM,
                                                        FABRIC_CUS)),
                         decide_every=4, warm=True)
    for eng in srv.engines.values():
        eng.warm_compile(None)
    torch.cuda.synchronize()
    return srv


def fabric_traffic(cfgs):
    """Each tenant's 8 requests (``serving_prompts``: 100-1000 tokens) in
    one burst at a step drawn from numpy seed 0 over 4x the requests, the
    span of the reference launcher's bursty pattern."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {t: (int(rng.integers(0, 4 * 8)), serving_prompts(cfg))
            for t, cfg in cfgs.items()}


def drive_fabric(torch, srv, traffic):
    """Serve ``traffic``; once minitron has a request in flight and half
    its work done, unify the card on it (``unify``).  Returns (streams by
    tenant in submission order, the wall in s, the manual unify's event,
    the steps)."""
    rids = {t: None for t in traffic}
    last = max(at for at, _ in traffic.values())
    uni, unify_event, step = "minitron-4b", None, 0
    t0 = time.perf_counter()
    while step <= last or any(e.has_work for e in srv.engines.values()):
        for t, (at, prompts) in traffic.items():
            if step == at:
                rids[t] = [srv.submit(t, p, max_new_tokens=FABRIC_NEW)
                           for p in prompts]
        eng = srv.engines[uni]
        if (unify_event is None and rids[uni] is not None
                and eng.active_count > 0
                and eng.pending_tokens() < 8 * FABRIC_NEW // 2):
            unify_event = srv.unify(uni)
        srv.step()
        step += 1
        require(step <= 2000, "the fabric did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = srv.results()
    return ({t: [res[t][r] for r in rids[t]] for t in traffic}, wall,
            unify_event, step)


def first_token_margin(torch, model, params, prompt, tokens):
    """The top-2 margin, relative to its largest |logit|, of the logits
    that pick the token after ``tokens``: a prefill of ``prompt`` then
    ``tokens`` on a fresh cache, the kernels on."""
    seq = list(prompt) + list(tokens)
    toks = torch.tensor([seq], dtype=torch.int32, device="cuda")
    cache = model.init_cache(1, len(seq) + 1)
    logits, _ = model.prefill(params, {"tokens": toks}, cache,
                              use_kernels=True)
    top2 = logits.float().topk(2, dim=-1).values[0]
    return (top2[0] - top2[1]).item() / logits.float().abs().max().item()


def lone_streams(torch, srv, tenant, prompts):
    """``prompts`` served by a lone engine of ``tenant`` (its class, its
    weights, its initial ServeConfig), warmed first."""
    from repro_torch.workloads.base import build_engine
    grp = srv.engines[tenant]
    eng = build_engine(srv.classes[tenant], grp._model, grp.params,
                       srv.specs[tenant].serve)
    eng.warm_compile(None)
    rids = [eng.submit(p, max_new_tokens=FABRIC_NEW) for p in prompts]
    res = eng.run_to_completion(1000)
    return [res[r] for r in rids]


def run_fabric_phase(torch):
    """Full-width minitron-4b (DecodeEngine) and falcon-mamba-7b
    (SSMEngine) as two tenants of one 8-CU fabric: bursty traffic, the
    policy recomposing live, one manual unify; the fabric's events, its
    captures on the serving path after warming (0), per-tenant tokens/s,
    decode p50 and TTFT, predicted against measured per-token cost per
    design key, peak memory and the four serving kernels' launches inside
    it.  Each tenant's streams must equal a lone engine's on the same
    requests and weights, except at counted near-ties.  Then the same run
    under the profiler: the busy share of the fabric's wall."""
    import gc
    card = card_line()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = make_fabric(torch)
    sizes = ", ".join(f"{t} ({c.param_count() / 1e9:.2f} B params)"
                      for t, c in srv.cfgs.items())
    log(f"fabric: {sizes} on {FABRIC_CUS} CUs of one card, built and warmed in "
        f"{time.perf_counter() - t0:.2f} s; initial composition "
        f"{srv.sizes()}; Stage 1 memory budget per CU "
        f"{srv.policy.stage1.mem_budget_bytes / 1e9:.2f} GB")
    traffic = fabric_traffic(srv.cfgs)
    bursts = {t: at for t, (at, _) in traffic.items()}
    plens = [len(p) for p in next(iter(traffic.values()))[1]]
    log(f"fabric traffic: burst steps {bursts}, 8 requests each of {plens} "
        f"prompt tokens, {FABRIC_NEW} new tokens")
    reset_counts(FABRIC_KERNELS)
    streams, wall, unify_event, steps = drive_fabric(torch, srv, traffic)
    launches = read_counts(FABRIC_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = srv.stats()
    for e in srv.events:
        log(f"fabric event step {e.step} {e.reason}"
            f"{' (manual)' if e is unify_event else ''}: "
            f"{e.sizes_before} -> {e.sizes_after}, moved {list(e.moved)}, "
            f"retuned {list(e.retuned)}, parked {list(e.parked)}, design "
            f"{e.design}, apply {e.seconds:.4f} s, warm builds "
            f"{e.warm_builds} in {e.warm_compile_seconds:.4f} s, first "
            f"step after {e.post_step_seconds} s")
    summ = srv.slo_summary()["tenants"]
    dec = srv.decode_step_ms()
    merged = srv.metrics()
    for t, st in streams.items():
        toks = sum(len(x) for x in st)
        ttft = summ[t].get("ttft_ms", {})
        dev = merged.merged_histogram("decode_device_s", tenant=t)
        log(f"fabric {t}: {toks} tokens in {wall:.3f} s = "
            f"{toks / wall:.1f} tokens/s; decode step p50 "
            f"{dec.get(t, {}).get('p50', float('nan'))} ms host, "
            f"{dev.quantile(0.5) * 1e3:.3f} ms on the device (its stream, "
            f"{dev.count} steps); TTFT p50 "
            f"{ttft.get('p50')} ms, p99 {ttft.get('p99')} ms; design "
            f"{stats['design_points'][t]}; graph captures on the serving "
            f"path {stats['serving_captures'][t]} ({card})")
    led = srv.ledger.summary()
    for key, ent in led["entries"].items():
        log(f"fabric ledger {key}: predicted {ent['predicted_unit_s']} s "
            f"per token (Stage 1 at commit), measured p50 "
            f"{ent['measured_p50_unit_s']} s per token on the device over "
            f"{ent['measured_n']} steps, predicted/measured {ent['ratio']}")
    log(f"fabric ledger aggregate {led['aggregate']}")
    log(f"fabric: {steps} steps, peak memory {peak:.2f} GiB, launches "
        f"inside the fabric {launches}; {stats['recompositions']} "
        f"recompositions in {stats['recompose_seconds']} s of apply and "
        f"{stats['warm_compile_seconds']} s of warming ({card})")
    policy_events = [e for e in srv.events if e is not unify_event]
    require(bool(policy_events), "no policy-driven recomposition")
    require(unify_event is not None and unify_event.reason == "unify",
            "no unify")
    require(all(n == 0 for n in stats["serving_captures"].values()),
            f"graph captures on the serving path after warm_compile: "
            f"{stats['serving_captures']}")
    for k in FABRIC_KERNELS:
        require(launches[k] > 0, f"{k} never launched inside the fabric")
    near_ties = 0
    for t, st in streams.items():
        vocab = srv.cfgs[t].vocab_size
        require(len(st) == 8 and all(len(x) == FABRIC_NEW for x in st)
                and all(0 <= v < vocab for x in st for v in x),
                f"fabric {t}: streams incomplete or out of the vocabulary")
        prompts = traffic[t][1]
        lone = lone_streams(torch, srv, t, prompts)
        grp = srv.engines[t]
        for i, (got, want) in enumerate(zip(st, lone)):
            if got == want:
                continue
            p = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            margin = first_token_margin(torch, grp._model, grp.params,
                                        prompts[i], want[:p])
            near_ties += 1
            log(f"fabric {t} request {i}: parts from the lone engine at "
                f"token {p} ({got[p]} vs {want[p]}); the lone path's top-2 "
                f"margin there {margin:.3e} (near-tie below "
                f"{ARGMAX_MARGIN:.0e})")
            require(margin < ARGMAX_MARGIN,
                    f"fabric {t} request {i} parts from the lone engine "
                    "away from a near-tie")
    log(f"fabric: streams equal the lone engines' but for {near_ties} "
        "near-tie(s)")
    params = {t: g.params for t, g in srv.engines.items()}
    del srv
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def run(fab):
        drive_fabric(torch, fab, traffic)

    profile_serving(torch, lambda: make_fabric(torch, params), run,
                    "fabric", FABRIC_KERNELS, wall, launches["mamba_step"],
                    None, None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# live resize and replica migration, full width, through CUDA graphs
# ---------------------------------------------------------------------------

def run_migration_phase(torch, model, params, scfg):
    """minitron-4b through ``DecodeEngine`` with graphs: the serving
    phase's 8 prompts (32 new tokens); at step 3 ``apply(slots=12)`` and 4
    more prompts (8 new tokens); at step 14 ``apply(slots=8)``; at step 16
    2 more prompts, queued (every slot is taken); at step 17 one request
    preempted (parked) and the engine evacuated: a second engine on the
    same params adopts its live and parked requests (``adopt_request``)
    and its queue (``adopt_queued``) and serves them to the end.  An
    uninterrupted engine runs the same submits and applies.  Every stream
    must equal the uninterrupted run's, and every ragged decode ticket
    buffer must read zero afterwards."""
    import numpy as np

    from repro_torch.core.dse import DesignPoint
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.workloads import DecodeEngine

    prompts = serving_prompts(model.cfg)
    rng = np.random.default_rng(1)
    extra = [rng.integers(1, model.cfg.vocab_size, size=int(n))
             for n in rng.integers(100, 600, size=6)]

    def run(migrate: bool):
        a = DecodeEngine(model, params, scfg)
        a.warm_compile(None)
        submitted = [(a.submit(p, max_new_tokens=32), p) for p in prompts]
        moved, b, steps = [], None, 0
        while a.has_work:
            if steps == 3:
                a.apply(point=DesignPoint(cus=0, slots=12))
                submitted += [(a.submit(p, max_new_tokens=8), p)
                              for p in extra[:4]]
            elif steps == 14:
                applied = a.apply(point=DesignPoint(cus=0, slots=8))
                require(applied == {"slots": 8}, f"shrink gave {applied}")
            elif steps == 16:
                submitted += [(a.submit(p, max_new_tokens=8), p)
                              for p in extra[4:]]
            elif steps == 17 and migrate:
                require(a.preempt_one() is not None, "nothing to preempt")
                live, queued = a.evacuate()
                require(len(live) == 8 and len(queued) == 2
                        and a.preempted_depth == 0 and not a.has_work,
                        f"evacuate left {len(live)} live, {len(queued)} "
                        "queued")
                b = DecodeEngine(model, params, scfg)
                for req, block in live:
                    b.adopt_request(req, block)
                for req in queued:
                    b.adopt_queued(req)
                moved = [req for req, _ in live] + queued
                while b.has_work:
                    b.step()
                    steps += 1
                    require(steps <= 1000, "migrated serving did not finish")
                b.results()
                break
            a.step()
            steps += 1
            require(steps <= 1000, "serving did not finish")
        torch.cuda.synchronize()
        done = a.results()
        out = {tuple(p.tolist()): done[rid] for rid, p in submitted
               if rid in done}
        out.update({tuple(r.tokens.tolist()): list(r.out_tokens)
                    for r in moved})
        engines = [e for e in (a, b) if e is not None]
        return out, steps, engines

    t0 = time.perf_counter()
    plain, plain_steps, plain_engines = run(False)
    moved, steps, engines = run(True)
    wall = time.perf_counter() - t0
    require(len(plain) == len(moved) == 14, f"{len(plain)} and {len(moved)} "
            "streams, want 14")
    require(all(len(plain[k]) == len(moved[k]) for k in plain),
            "migrated streams are incomplete")
    require(moved == plain, "streams after resize, evacuate and adopt "
            "differ from the uninterrupted run")
    tickets = [g.tickets for e in engines + plain_engines
               for g in graph_steps(e)] + list(rd._tickets.values())
    nonzero = sum(int(t.abs().sum().item()) for t in tickets)
    require(nonzero == 0, f"ragged decode tickets left at {nonzero}")
    log(f"migration {model.cfg.name}: 14 requests, slots 8 -> 12 (step 3) "
        f"-> 8 (step 14), evacuate at step 17 (8 live incl. 1 parked, 2 "
        f"queued) into a second engine; {steps} steps (uninterrupted "
        f"{plain_steps}); streams equal the uninterrupted run's, token "
        f"for token; {len(tickets)} ticket buffers read zero; graph "
        f"captures {[e.graph_captures for e in engines]} (uninterrupted "
        f"{[e.graph_captures for e in plain_engines]}); both runs "
        f"{wall:.2f} s")


# ---------------------------------------------------------------------------
# kernel path against plain path, full width, one short prompt
# ---------------------------------------------------------------------------

def path_logits(torch, paths, *, steps: int = 5):
    """fp32 logits of each path on one 100-token prompt and after each of
    ``steps`` decode steps, every path fed the last path's argmax.  A path
    is (model, params, use_kernels).  Returns, per position, the list of
    the paths' logits."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    S = 100
    toks = torch.randint(1, paths[0][0].cfg.vocab_size, (1, S),
                         generator=gen, device="cuda", dtype=torch.int32)
    caches = [m.init_cache(1, S + steps + 3) for m, _, _ in paths]
    logits = [None] * len(paths)
    for i, (m, p, kern) in enumerate(paths):
        logits[i], caches[i] = m.prefill(p, {"tokens": toks}, caches[i],
                                         use_kernels=kern)
    out = [[x.float() for x in logits]]
    for _ in range(steps):
        nxt = logits[-1].argmax(-1).to(torch.int32)[:, None]
        for i, (m, p, kern) in enumerate(paths):
            logits[i], caches[i] = m.decode_step(p, caches[i], nxt,
                                                 use_kernels=kern)
        out.append([x.float() for x in logits])
    return out


def rel_err(a, ref) -> float:
    """max|a - ref| relative to the largest |ref|."""
    return ((a - ref).abs().max() / ref.abs().max()).item()


def argmax_check(a, ref, margin_tol: float):
    """(argmax equal, ref's top-2 margin relative to its largest |logit|,
    ok): a may pick another token only where that margin is below
    ``margin_tol``."""
    top2 = ref.topk(2, dim=-1).values[0]
    margin = (top2[0] - top2[1]).item() / ref.abs().max().item()
    same = bool((a.argmax(-1) == ref.argmax(-1)).all().item())
    return same, margin, same or margin < margin_tol


def run_reference_check(torch, path_a, path_b, *, tol, label):
    """Path a against path b, both fed b's argmax.  Fails when
    max|a - b| / max|b| exceeds ``tol`` at any position, or the argmax
    parts where b's top-2 margin is not below min(tol, ARGMAX_MARGIN).
    Returns the largest relative difference."""
    worst = 0.0
    for step, (a, b) in enumerate(path_logits(torch, (path_a, path_b))):
        rel = rel_err(a, b)
        same, margin, ok = argmax_check(a, b, min(tol, ARGMAX_MARGIN))
        log(f"{label} step {step}: max|dlogit|/max|logit| = {rel:.3e} "
            f"(tol {tol:.0e}), argmax equal {same}, top-2 margin of b "
            f"{margin:.3e}")
        require(math.isfinite(rel) and rel <= tol and ok,
                f"{label}: the two paths disagree at step {step}")
        worst = max(worst, rel)
    return worst


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_fp32(v) for v in tree]
    return tree.float()


def run_ssm_reference_checks(torch, model):
    """falcon-mamba-7b at full depth, for each weight seed of
    ``SSM_CHECK_SEEDS``: four paths on the same tokens, the kernel and the
    plain path in bf16 and on an fp32 copy of the same weights.  In fp32
    the kernel path must compute the plain path's function
    (``FP32_LOGIT_REL_TOL``).  In bf16 its distance from the fp32 plain
    path, the largest over all positions, must stay within
    1 + ``SSM_FLOOR_MARGIN`` times the bf16 plain path's (the model's own
    rounding floor, measured here), and its argmax must be the fp32 plain
    path's wherever that path's top-2 margin is ``ARGMAX_MARGIN`` or
    more."""
    import dataclasses

    from repro_torch.models.model import build_model

    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"), "cuda")
    for seed in SSM_CHECK_SEEDS:
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
        p32 = to_fp32(params)
        label = f"reference check falcon-mamba-7b seed {seed}"
        paths = ((model, params, True), (model, params, False),
                 (m32, p32, True), (m32, p32, False))
        worst = dict.fromkeys(("kernel bf16", "plain bf16",
                               "bf16 kernel vs plain", "fp32 kernel vs plain"),
                              0.0)
        for step, (k16, p16, k32, f32) in enumerate(
                path_logits(torch, paths)):
            errs = (rel_err(k16, f32), rel_err(p16, f32), rel_err(k16, p16),
                    rel_err(k32, f32))
            same32, _, ok32 = argmax_check(k32, f32, FP32_LOGIT_REL_TOL)
            same16, margin, ok16 = argmax_check(k16, f32, ARGMAX_MARGIN)
            log(f"{label} step {step}: distance from plain fp32, kernel bf16 "
                f"{errs[0]:.3e}, plain bf16 {errs[1]:.3e}; bf16 kernel vs "
                f"plain {errs[2]:.3e}; fp32 kernel vs plain {errs[3]:.3e} "
                f"(tol {FP32_LOGIT_REL_TOL:.0e}), argmax equal {same32}; bf16 "
                f"kernel argmax equal to fp32's {same16}, fp32 top-2 margin "
                f"{margin:.3e}")
            require(all(map(math.isfinite, errs)),
                    f"{label}: non-finite logits at step {step}")
            require(errs[3] <= FP32_LOGIT_REL_TOL and ok32,
                    f"{label}: fp32 kernel path disagrees with the plain "
                    f"path at step {step}")
            require(ok16, f"{label}: bf16 kernel path picks another token "
                          f"than fp32 at step {step} (margin {margin:.3e})")
            for key, e in zip(worst, errs):
                worst[key] = max(worst[key], e)
        limit = (1 + SSM_FLOOR_MARGIN) * worst["plain bf16"]
        log(f"{label}: largest over positions, distance from plain fp32: "
            f"kernel bf16 {worst['kernel bf16']:.3e}, limit {limit:.3e} = "
            f"(1 + {SSM_FLOOR_MARGIN}) x the bf16 floor "
            f"{worst['plain bf16']:.3e}; bf16 kernel vs plain "
            f"{worst['bf16 kernel vs plain']:.3e}; fp32 kernel vs plain "
            f"{worst['fp32 kernel vs plain']:.3e}")
        require(worst["kernel bf16"] <= limit,
                f"{label}: the bf16 kernel path is further from fp32 than "
                f"the bf16 rounding floor allows")
        del params, p32, paths
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the paper path (filco_mm sweep, BERT-128 on the data plane)
# ---------------------------------------------------------------------------

def run_paper_kernel_phase(torch, reps: int = 20):
    """The filco_mm sweep.  Inputs are uniform in [-1, 1), b scaled by
    1/sqrt(K) as the path's weights are, so outputs are O(1) (std about
    1/3) and a bf16 ulp stays below ``TOL``.  Each dims first against the
    plain version, into an output that starts as NaN (dead tiles and
    masked edges must write zeros); then the timed sweep, which is
    ``static_mm``'s path as fig8 is in the JAX package.  Returns the
    kernels' entries and the sweep's launch counts."""
    from repro_torch.kernels.filco_mm import ops as fm
    from repro_torch.kernels.filco_mm.ref import flex_mm_ref, static_mm_ref

    X = SWEEP_BUF
    shapes = [(X // f,) * 3 for f in SWEEP_FRACS] + [SWEEP_RAGGED]
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"flex_mm": 0.0, "static_mm": 0.0}
    bufs = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        a = (torch.rand((X, X), generator=gen, device="cuda") * 2 - 1).to(dt)
        b = ((torch.rand((X, X), generator=gen, device="cuda") * 2 - 1)
             / math.sqrt(X)).to(dt)
        bufs[dtype] = (a, b)
        tol = TOL[dtype]
        for mkn in shapes:
            m, _, n = mkn
            dims = torch.tensor(mkn, dtype=torch.int32, device="cuda")
            out = torch.full((X, X), float("nan"), dtype=dt, device="cuda")
            fm.flex_mm(a, b, dims, out=out)
            want = flex_mm_ref(a, b, dims)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            zeros = bool((out[m:] == 0).all().item()
                         and (out[:, n:] == 0).all().item())
            log(f"flex_mm {dtype} buffer {X}^3 dims {mkn}: max_abs_err "
                f"{err:.3e} tol {tol:.0e}, zero outside [:m, :n] {zeros}")
            require(err <= tol and agree(out, want, tol) and zeros,
                    f"flex_mm {dtype} {mkn} disagrees with its plain version")
            worst["flex_mm"] = max(worst["flex_mm"], err)
        got = fm.static_mm(a, b)
        want = static_mm_ref(a, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        log(f"static_mm {dtype} {X}^3: max_abs_err {err:.3e} tol {tol:.0e}")
        require(err <= tol and agree(got, want, tol),
                f"static_mm {dtype} disagrees with its plain version")
        worst["static_mm"] = max(worst["static_mm"], err)
        del out, want, got

    reset_counts(("static_mm",))
    results = {}
    static_atoms = fm.atoms_issued_static(X, X, X)
    bm, bn, bk, splits = fm.plan(X, X, X)
    gx, gy, _ = fm.grid(X, X, bm, bn, splits)
    log(f"filco_mm sweep plan for the {X}^3 buffer: tile {bm}x{bn}x{bk}, "
        f"{splits} split(s), {gx * gy * splits} blocks")
    for dtype, (a, b) in bufs.items():
        es = a.element_size()
        static_ms = time_ms(torch, lambda: fm.static_mm(a, b), reps)
        for mkn in shapes:
            m, k, n = mkn
            dims = torch.tensor(mkn, dtype=torch.int32, device="cuda")
            ms_ = time_ms(torch, lambda: fm.flex_mm(a, b, dims), reps)
            av, bv = a[:m, :k], b[:k, :n]
            lib_ms = time_ms(torch, lambda: torch.matmul(av, bv), reps)
            # inputs' valid regions read once, the whole buffer written;
            # fp32 on the tensor cores as 3xTF32, the CUDA-core bound beside
            nbytes, flops = (m * k + k * n + X * X) * es, 2 * m * k * n
            b_ms, b_by = bound(nbytes, flops, dtype, tf32x3=True)
            by, cc = b_by, ""
            if dtype == "float32":
                by += ", 3xTF32" if b_by == "operations" else ""
                cc = (f"; CUDA-core fp32 bound "
                      f"{bound(nbytes, flops, dtype)[0]:.4f} ms")
            atoms = fm.atoms_issued_flexible(m, k, n, buf=(X, X, X))
            log(f"filco_mm sweep {dtype} buffer {X}^3 dims {mkn}: flex_mm "
                f"{ms_:.4f} ms, static_mm {static_ms:.4f} ms (whole "
                f"buffer), live tiles {atoms} of {static_atoms} "
                f"({atoms / static_atoms:.4f}), bound {b_ms:.4f} ms "
                f"({by}){cc}, torch.matmul on the valid slices "
                f"{lib_ms:.4f} ms; {flops / ms_ / 1e9:.1f} TFLOP/s")
            if mkn == (X, X, X) and dtype == "float32":
                plain_ms = time_ms(torch, lambda: flex_mm_ref(a, b, dims),
                                   max(reps // 4, 3))
                static_plain_ms = time_ms(
                    torch, lambda: static_mm_ref(a, b), max(reps // 4, 3))
                log(f"filco_mm plain versions fp32 {X}^3: flex_mm_ref "
                    f"{plain_ms:.4f} ms, static_mm_ref "
                    f"{static_plain_ms:.4f} ms")
                src = "src/repro_torch/kernels/filco_mm/csrc/filco_mm.cu"
                results["flex_mm"] = dict(
                    name="flex_mm", route="cuda", source=src,
                    replaces="src/repro/kernels/filco_mm/kernel.py:86",
                    max_abs_err=worst["flex_mm"], ms=ms_, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
                results["static_mm"] = dict(
                    name="static_mm", route="cuda", source=src,
                    replaces="src/repro/kernels/filco_mm/kernel.py:124",
                    max_abs_err=worst["static_mm"], ms=static_ms,
                    plain_ms=static_plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)
    launches = read_counts(("static_mm",))
    del bufs
    torch.cuda.empty_cache()
    return results, launches


def run_paper_shape_table(torch, dims, reps: int = 20):
    """``flex_mm`` at each CU pass shape of the path, with buffers exactly
    the pass as the simulator hands its windows over and operands scaled
    as the DDR image scales them: against its plain version, its time,
    ``torch.matmul``'s on the same windows (TF32 off), the bound (bytes,
    or 3xTF32 operations) and the plan.  Then the host's enqueue of one
    ``flex_mm`` call, over as many calls as the path has passes."""
    from collections import Counter

    from repro_torch.kernels.filco_mm import ops as fm
    from repro_torch.kernels.filco_mm.ref import flex_mm_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    counts = Counter(dims)
    tot = tot_lib = 0.0
    log("paper path per-shape table (m, k, n) x passes: flex_mm ms, "
        "torch.matmul ms, bound ms (by), plan tile/splits/blocks, max rel "
        "err")
    for (m, k, n), count in sorted(counts.items()):
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        d = torch.tensor((m, k, n), dtype=torch.int32, device="cuda")
        out = torch.full((m, n), float("nan"), device="cuda")
        fm.flex_mm(a, b, d, out=out)
        want = flex_mm_ref(a, b, d)
        err = ((out - want).abs().max() / want.abs().max()).item()
        require(agree(out, want, TOL["float32"]),
                f"flex_mm at pass shape {(m, k, n)} disagrees with its plain "
                f"version")
        ms_ = time_ms(torch, lambda: fm.flex_mm(a, b, d, out=out), reps)
        lib_ms = time_ms(torch, lambda: torch.matmul(a, b), reps)
        b_ms, b_by = bound(4 * (m * k + k * n + m * n), 2 * m * k * n,
                           "float32", tf32x3=True)
        bm, bn, bk, splits = fm.plan(m, k, n)
        gx, gy, _ = fm.grid(m, n, bm, bn, splits)
        tot += count * ms_
        tot_lib += count * lib_ms
        log(f"  {(m, k, n)} x {count}: {ms_:.4f} | {lib_ms:.4f} | "
            f"{b_ms:.4f} ({b_by}{', 3xTF32' if b_by == 'operations' else ''})"
            f" | {bm}x{bn}x{bk} / {splits} / {gx * gy * splits} | {err:.2e}")
    log(f"paper path per-shape times weighted by passes: flex_mm "
        f"{tot:.3f} ms, torch.matmul {tot_lib:.3f} ms (each launch with a "
        f"cold L2)")
    (m, k, n), count = counts.most_common(1)[0]
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    d = torch.tensor((m, k, n), dtype=torch.int32, device="cuda")
    out = torch.empty((m, n), device="cuda")
    fm.flex_mm(a, b, d, out=out)
    torch.cuda.synchronize()
    passes = len(dims)
    t0 = time.perf_counter()
    for _ in range(passes):
        fm.flex_mm(a, b, d, out=out)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"paper path host: {passes} flex_mm calls at {(m, k, n)} enqueue in "
        f"{host_s * 1e3:.3f} ms ({host_s / passes * 1e6:.1f} us per call)")


def run_paper_path_phase(torch):
    """Full-width BERT-128 through the port's entry point with the
    example's DSE settings (``run_path``): host DSE, codegen,
    ``DataPlaneSim`` on the card from a numpy seed-0 DDR image, and every
    layer held to the plain fp32 walk.  The flex_mm launches must equal
    the program's CU passes.  Then the same program again under the
    profiler for the device time of the launches.  Returns the launch
    counts of the run."""
    from repro_torch.configs.paper_workloads import PAPER_WORKLOADS
    from repro_torch.core.simulator import cu_pass_dims
    from repro_torch.kernels.filco_mm import ops as fm
    from repro_torch.launch.dse_to_silicon import run_path

    wl = PAPER_WORKLOADS[PAPER_WORKLOAD]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(("flex_mm",))
    run = run_path(wl, device="cuda")
    launches = read_counts(("flex_mm",))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    s = run.stats
    dims = cu_pass_dims(run.prog)
    passes = len(dims)
    log(f"paper path {wl.name}: {s['layers']} MM layers, "
        f"{wl.total_flops / 1e9:.2f} GFLOP, {passes} CU passes in "
        f"{s['pass_shapes']} shapes, {s['instr_bytes']} instruction bytes, "
        f"DDR {s['ddr_elems']} fp32 elements, {s['fmus']} FMUs of "
        f"{s['fmu_elems']}; DSE {s['dse_s']:.3f} s (stage 1 "
        f"{run.dse.stage1_s:.3f}, stage 2 {run.dse.stage2_s:.3f}), codegen "
        f"{s['codegen_s']:.4f} s, sim wall {s['sim_s']:.4f} s; flex_mm "
        f"launches {launches['flex_mm']}; peak memory {peak_gib:.3f} GiB")
    # what the passes need: operands read and results written once, the
    # useful products (fp32 as 3xTF32); beside them what the plan's tiles
    # issue and how many blocks each pass launches
    ceil = lambda x, a: -(-x // a)
    nbytes = sum(4 * (m * k + k * n + m * n) for m, k, n in dims)
    flops = sum(2 * m * k * n for m, k, n in dims)
    issued, blocks = 0, []
    for m, k, n in dims:
        bm, bn, bk, splits = fm.plan(m, k, n)
        issued += 2 * fm.atoms_issued_flexible(m, k, n) * bm * bk * bn
        gx, gy, _ = fm.grid(m, n, bm, bn, splits)
        blocks.append(gx * gy * splits)
    b_ms, b_by = bound(nbytes, flops, "float32", tf32x3=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"paper path {wl.name}: the passes move {nbytes / 1e9:.3f} GB and "
        f"make {flops / 1e9:.2f} GFLOP, bound {b_ms:.4f} ms ({b_by}; as "
        f"3xTF32 the products take {3 * flops / TF32_FLOPS * 1e3:.4f} ms, on "
        f"CUDA cores {flops / F32_FLOPS * 1e3:.4f} ms); the plan's tiles "
        f"issue {issued / 1e9:.2f} GFLOP in {min(blocks)}-{max(blocks)} "
        f"blocks per pass on {sms} SMs")
    log(f"paper path {wl.name}: largest |DDR - walk| / max |walk| over "
        f"layers {s['max_rel_err']:.3e} (tol {s['rel_tol']:.0e}), at layer "
        f"{int(run.errors.argmax())}")
    require(launches["flex_mm"] == passes,
            f"flex_mm launched {launches['flex_mm']} times for {passes} CU "
            f"passes")
    require(s["ok"], f"paper path {wl.name}: a layer's DDR result disagrees "
                     f"with the walk ({s['max_rel_err']:.3e})")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run.sim.run(run.prog)
        torch.cuda.synchronize()
    kern_ms = other_ms = 0.0
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0.0)
              or getattr(ev, "device_time_total", 0.0))
        if "filco_mm" in ev.key:
            kern_ms += us / 1e3
        else:
            other_ms += us / 1e3
    if kern_ms > 0:
        log(f"paper path {wl.name} profile: flex_mm device time "
            f"{kern_ms:.3f} ms over {passes} launches "
            f"({wl.total_flops / (kern_ms * 1e-3) / 1e12:.2f} TFLOP/s), "
            f"other device time (FMU and DDR copies) {other_ms:.3f} ms; "
            f"unprofiled sim wall {s['sim_s'] * 1e3:.3f} ms")
    else:
        log(f"paper path {wl.name} profile: the profiler recorded no device "
            f"time (flex_mm device time not measured)")
    # the host's side: enqueue of the whole program (309 kernel launches
    # and the FMU and DDR copies) against its wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.sim.run(run.prog)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"paper path {wl.name} host: DataPlaneSim.run enqueues the program "
        f"in {(t1 - t0) * 1e3:.3f} ms of {(t2 - t0) * 1e3:.3f} ms wall")
    run_paper_shape_table(torch, dims)
    del run
    torch.cuda.empty_cache()
    return launches


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
    from repro_torch.workloads import DecodeEngine, SSMEngine, ServeConfig

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
        entry = ""
        for line in build_log.read_text().splitlines():
            if "Compiling entry function" in line:
                # the mangled name's tail: kernel, template arguments
                entry = line.split("'")[1][-64:]
            elif "registers" in line or line.startswith("=="):
                log(f"  {entry} {line.strip()}" if "registers" in line
                    else "  " + line.strip())
            elif "spill" in line and " 0 bytes spill stores" not in line:
                log(f"  {entry} {line.strip()}")

    if "--scan-baseline" in sys.argv:
        log_scan_build()
        run_scan_compare(torch, [Path(p) for p in sys.argv[sys.argv.index(
            "--scan-baseline") + 1:]])
        print(card_line(), flush=True)
        return 0

    start = time.perf_counter()
    phase_s = lambda: f"{time.perf_counter() - start:.1f} s"
    kernels = run_kernel_phase(torch)
    kernels.update(run_ssm_kernel_phase(torch))
    log(f"kernel phases done at {phase_s()} after the build")
    paper_kernels, launches = run_paper_kernel_phase(torch)
    kernels.update(paper_kernels)
    launches.update(run_paper_path_phase(torch))
    log(f"paper phase done at {phase_s()}")

    # minitron-4b through the decode engine, then freed
    cfg = get_config("minitron-4b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"minitron-4b: {cfg.param_count() / 1e9:.2f} B params, random bf16 "
        f"weights in {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(max_slots=8, max_len=2048, eos_id=-1,
                       use_kernels=True)
    launches.update(run_serving_phase(
        torch, model, params, DecodeEngine, scfg, per_step="ragged_decode",
        per_prefill="flash_attention")[0])
    run_migration_phase(torch, model, params, scfg)
    torch.cuda.empty_cache()
    run_reference_check(torch, (model, params, True), (model, params, False),
                        tol=LOGIT_REL_TOL, label="reference check minitron-4b")
    del model, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"minitron-4b phase done at {phase_s()}")

    # falcon-mamba-7b through the SSM engine: max_len 512 is below three
    # of the prompts, which are served all the same (slot-bound admission)
    cfg = get_config("falcon-mamba-7b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"falcon-mamba-7b: {cfg.param_count() / 1e9:.2f} B params, random "
        f"bf16 weights in {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(max_slots=8, max_len=512, eos_id=-1, use_kernels=True)
    arena = SSMEngine(model, params, scfg).arena
    log(f"falcon-mamba-7b admission: arena of {arena.capacity} state "
        f"elements = {scfg.max_slots} slots x one slot's state over "
        f"{cfg.num_layers} layers, whatever max_len")
    launches.update(run_serving_phase(
        torch, model, params, SSMEngine, scfg, per_step="mamba_step",
        per_prefill="mamba_scan")[0])
    pdl_edge_check(torch, SSMEngine, model, params, scfg)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    run_ssm_reference_checks(torch, model)
    del model
    log(f"falcon-mamba-7b phase done at {phase_s()}")

    # both models as two tenants of one composed card
    run_fabric_phase(torch)
    log(f"fabric phase done at {phase_s()}")

    entries = []
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        require(entry["launches"] > 0, f"{name} never launched on its path")
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
