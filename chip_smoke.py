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
7. Enc-dec phase: full-width seamless-m4t-medium (12 encoder and 12
   decoder layers, random bf16 weights from seed 0) through
   ``EncDecEngine``, the kernels on: phase 3's 8 prompts as sources (a
   bidirectional encode per source bucket through the flash kernel with
   per-row key padding), [bos] decoder prompts, 32 new tokens, 8 slots, on
   four fresh engines in turns (graphs, eager, graphs, eager).  Logs the
   admission encodes' device time, prefill ms, decode p50, tokens/s,
   captures on the serving path (0 with graphs) and the attention
   kernels' launches; streams must be equal; the kernel path's logits are
   held to the plain path's in bf16 (5e-2 of the largest |logit|) and on
   an fp32 copy (1e-3), the argmax parting only at counted near-ties.  The
   kernel phase holds the masked flash kernel to its plain version over B
   in {1, 8}, S in {1, 63, 64, 65, 1024}, head_dim 64 and 128, causal and
   not, bf16 and fp32, and times it at the seamless encoder's shapes
   beside SDPA under the same mask.
8. Encoder phase: qwen2.5-32b at its published widths cut to 16 of 64
   layers, through ``EncoderEngine``: 16 jobs of 64-2048 tokens on the
   ladder (512, 1024, 2048); sequences/s, embeddings against the plain
   path, and one job's largest embedding difference across two ladders.
9. Mixed-fleet phase: the launcher's ``serve_fabric`` in process with
   ``--scenario flash-crowd`` over its MIXED_FLEET (the four classes, the
   encoder tenant cut to 16 layers) on 8 CUs, paged KV at ``--kv-frac
   0.4``: per-class throughput, TTFT, events, preemptions (at least one),
   SLO attainment, captures on the serving path (0), peak memory and the
   five serving kernels' launches (each must launch); every stream equals
   a slot-granular replay of the same schedule but at counted near-ties.
10. MLA and MoE phase: full-width deepseek-v2-lite-16b (27 layers, 64
   routed experts top-6 and 2 shared, MLA; random bf16 weights from seed
   0, 31.4 GB) through ``DecodeEngine`` with the kernels on: phase 3's 8
   prompts, 32 new tokens, 8 slots, ``max_len`` 2048, decode steps as
   graphs then eager (streams equal, 0 captures on the serving path, the
   flash kernel at head dim 192 launched 27 times per prefill, peak
   memory under 80 GiB).  Logs prefill ms, decode p50, tokens/s, the
   decode step beside its bound and by module (MoE dispatch, routed and
   shared experts, MLA), and the busy share; holds the kernel path's
   logits to the plain path's with the router pinned to the plain path's
   experts, in bf16 (5e-2) and in fp32 (1e-3) at full depth, and logs the
   routing partings, the unpinned distance and the bf16 rounding floor.
   The kernel phase holds flash at head dims 24, 192 and 256 (causal,
   windowed, key-padded, S 65) in bf16 and fp32 and times it at
   deepseek's prefill shape beside SDPA.
11. Multi-query phase: full-width granite-34b (88 layers, 48 query heads
   on one KV head, random bf16 weights from seed 0, 67.9 GB) through
   ``DecodeEngine``: phase 3's 8 prompts, 32 new tokens, 8 slots,
   ``max_len`` 2048, graphs then eager (streams equal, 0 captures on the
   serving path, ragged decode 88 launches per step, flash 88 per
   prefill, peak memory under 80 GiB); a decode step beside its weight
   bound; kernel path against plain path in bf16 at full depth (5e-2) and,
   the bf16 weights freed, in fp32 at the published widths cut to 16 of 88
   layers (1e-3).  The kernel phase holds ragged decode in head groups of
   at most 8 at G = 48, 9 and 5 (with a window, on sliding and global
   layers) and times G = 48 at granite's serving shape beside SDPA; it
   holds flash at granite's heads (48 on 1, D 128, causal) and hymba's
   (25 on 5, D 64, window 1024, sliding and global) at S 65 and 1100.
12. Hybrid phase: full-width hymba-1.5b (32 layers of attention beside
   Mamba, window 1024 but 3 global layers; random bf16 weights from seed
   0) through ``DecodeEngine``: 8 prompts, two past the window, 32 new
   tokens, graphs then eager (streams equal, 0 captures; per step 32
   launches of ragged decode and of the Mamba step, per prefill 32 of
   flash and of the scan); a decode step beside its bound; kernel path
   against plain path from an 1100-token prompt for three weight seeds,
   fp32 within 1e-3 and bf16 within 1.25x the model's own rounding floor.
   The kernel phase holds the Mamba step at hymba's widths (x_proj and
   dt_proj on the CUDA-core product, checked) in bf16 and fp32 with a dead
   slot, and the scan at d_in 3200 up to S 1500.
13. Training phase: full-width minitron-4b (32 layers, fp32 master
   weights from seed 0, bf16 activations, AdamW, remat; B 4 x S 1024 from
   the port's ``SyntheticLM``), on the card the serving phases left empty:
   one forward and backward on the kernel path against the plain path
   from the same params and batch (loss within 2e-2 relative, each
   gradient leaf within 5e-2 in relative norm), the same at the published
   widths cut to 4 layers in fp32 (1e-4, 1e-3), then 8 steps of
   ``make_train_step`` (lr 3e-4, warmup 2): every loss and grad norm
   finite and the last loss below step 1's.  Logs step ms (median of
   steps 3-7), tokens/s, the share of 989 TFLOP/s, the optimizer's ms
   (CUDA events), peak memory (under 78 GiB) and the launches of the flash
   forward with lse and the flash backward (32 of the backward per step).
   The kernel phase holds the forward's lse and the backward kernel to
   their plain versions at minitron's training shape, granite's 48 heads
   on 1, llama-100m's D 64 (causal and bidirectional) and S 1000, in bf16
   and fp32, and times each in bf16 beside its bound and SDPA's forward
   plus backward, with the backward's head split (``bwd_plan``), grids
   and TFLOP/s; the fp32 backward is timed at minitron's and granite's
   shapes.  It does the same at deepseek-v2-lite's MLA training shape (B
   4, S 1024, 16 heads on 16, q/k head dim 192, causal), where the
   backward runs its eight-warp instances.
14. MoE and MLA training phase: full-width deepseek-v2-lite-16b (fp32
   masters from seed 0, bf16 activations, AdamW, remat, the einsum
   dispatch; B 4 x S 1024 of ``SyntheticLM``) cut to ``DS_TRAIN_LAYERS``
   of 27 layers (the dense layer and the rest MoE), after minitron's: the
   kernel path against the plain path at 2 layers in fp32 (1e-4, 1e-3)
   and at the cut in bf16 (2e-2, 5e-2), each with the router pinned to
   the plain path's experts in the forward and in the remat recompute
   (the unpinned distances and routing partings logged), then 8 steps of
   ``make_train_step``: losses and grad norms finite, the last loss below
   step 1's, peak memory under 78 GiB, the flash kernels at head dim 192
   launched every layer of every step.  Logs step ms, tokens/s, the share
   of 989 TFLOP/s counting the experts the model routes to (and the
   FLOPs the einsum dispatch executes), the optimizer's ms and the step
   by kind (flash, cuBLAS, the MoE dispatch from one layer timed alone,
   AdamW, other).
15. SSM and hybrid training phases: full-width hymba-1.5b (32 layers,
   1.66 B params as fp32 masters, bf16 activations, AdamW, remat) at B 2
   x S 2048, past its window of 1024 so that the window masks keys, and
   falcon-mamba-7b at its published widths cut to 32 of 64 layers (58.1 GiB of masters, grads and moments) at B 4 x S
   1024: the kernel path against the plain path at a few layers in fp32
   (hymba: a global layer and two windowed ones) and at the phase's depth
   in bf16 (``TRAIN_TOL``), then 8 steps of ``make_train_step``: losses
   and grad norms finite, the last loss below the first and step 1's,
   peak memory under 78 GiB, the scan's training forward and its backward
   kernel launched every layer of every step, hymba's windowed flash
   backward on every sliding layer.  Logs step ms, tokens/s, the share of
   989 TFLOP/s, the optimizer's ms, peak memory and the step by kind.
   The kernel phase holds the scan with its boundary states (its y
   bitwise the serving instance's) and the scan's backward kernel to the
   plain pair at falcon's layer (B 4, S 1024, d_in 8192) and hymba's (B
   2, S 2048, d_in 3200), bf16 and fp32, and times both beside their
   bounds; it holds the windowed flash forward with lse and backward at
   hymba's training shape (B 2, S 2048, 25 on 5, D 64, window 1024) and
   times them beside the bound over the window's attended pairs, SDPA's
   forward and backward under the same mask, and the same backward on a
   global layer.
16. Trainer phase: llama-100m through ``launch/train.py``'s restart loop
   in process, 30 steps at S 256, B 8, with checkpoints in a temporary
   directory under ``build/``: once uninterrupted, once preempted by a
   flag file at step 10 and resumed from its checkpoint; the resumed
   run's losses must equal the uninterrupted run's within 1e-3 relative,
   and its last loss must be below its first.

Prints a ``{"kernels": [...]}`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device,
outside a checkout of the repository, or when any phase fails.

    python3 chip_smoke.py --scan-baseline DIR [DIR ...]

builds the kernels and only times the selective scan of each other
checkout DIR (its own mamba_scan.cu, e.g. the parent commit unpacked with
``git archive``) beside this checkout's, in turns on one card; each
other checkout's y and last state must equal this checkout's serving
instance's bitwise, and this checkout's training instance (boundary
states on) gives the same y.

    python3 chip_smoke.py --flash-baseline DIR [DIR ...]

does the same for the causal flash kernel (its flash_attention.cu) at a
1024-token prompt, B = 1 and 4, and for its backward without a window
(flash_attention_bwd.cu) at minitron's and granite's training shapes;
outputs must be bitwise equal.
"""
from __future__ import annotations

import contextlib
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
# most this share (serving: the logits; training, ssm_floor_check: the
# gradient leaves' rms distance).  Both are bf16 roundings at the same
# points, differing in summation order only, so their distances from fp32
# are two draws from one spread (the floor moved by +-8% from step to
# step on an H100).
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
        B, Hq, Hkv, T,
        torch.cuda.get_device_properties(0).multi_processor_count)
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
    worst = max(worst, run_family_flash_checks(torch, gen))
    ms, plain_ms, lib_ms, b_ms, b_by = timing[1024]
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    results.update(run_masked_flash_phase(torch, gen, reps))
    results.update(run_mla_flash_phase(torch, gen, reps))
    results.update(run_group_decode_phase(torch, gen, reps))
    return results


# flash at the heads of the last serving families: (label, Hq, Hkv, D,
# window, is_global); granite is multi-query and causal, hymba slides a
# window of 1024 but on its global layers
FAMILY_FLASH = (("granite MQA", 48, 1, 128, 0, False),
                ("hymba sliding", 25, 5, 64, 1024, False),
                ("hymba global", 25, 5, 64, 1024, True))


def run_family_flash_checks(torch, gen):
    """The flash kernel against its plain version at ``FAMILY_FLASH``'s
    heads, causal, at S 65 and 1100 (past hymba's window), in bf16 and
    fp32.  Fails the run on a miss; returns the largest bf16 error."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    worst = 0.0
    for label, Hq, Hkv, D, window, glob in FAMILY_FLASH:
        for S in (65, 1100):
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                q, k, v = (torch.randn((1, S, h, D), generator=gen,
                                       device="cuda").to(dt)
                           for h in (Hq, Hkv, Hkv))
                kw = dict(causal=True, window=window, is_global=glob)
                got = fa.flash_attention(q, k, v, **kw)
                want = flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                log(f"flash_attention {label} (Hq {Hq}, Hkv {Hkv}, D {D}, "
                    f"window {window}, global {glob}) S={S} {dtype}: "
                    f"max_abs_err={err:.3e} tol={TOL[dtype]:.0e}")
                require(err <= TOL[dtype] and math.isfinite(err),
                        f"flash_attention {label} S={S} {dtype} disagrees "
                        f"with its plain version")
                if dtype == "bfloat16":
                    worst = max(worst, err)
    return worst


# ragged decode past 8 query heads per KV head: (label, Hq, Hkv, D)
GROUP_CASES = (("G48 granite", 48, 1, 128), ("G9", 18, 2, 128),
               ("G5 hymba", 25, 5, 64))


def run_group_decode_phase(torch, gen, reps: int):
    """The ragged decode kernel in head groups of at most 8 against its
    plain version: granite's multi-query group (Hq 48 on 1 KV head, D 128:
    6 groups of 8), G = 9 (groups of 5 and 4) and hymba's G = 5 (D 64), in
    bf16 and fp32, plain and with a window of 256 under a logit cap, on a
    sliding and on a global layer; the phase-2 lengths with a dead slot.
    Then G = 48 timed at granite's serving shape (8 slots, bf16, 3043 live
    rows) beside the plain version and SDPA on the same mask (K and V
    repeated to 48 heads outside the timed call); the bound is the live
    rows' KV bytes plus q, the output and the lengths."""
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.kernels.ragged_decode.ref import \
        ragged_decode_attention_ref
    F = torch.nn.functional
    lengths = [1000, 517, 129, 1, 64, 999, 700, 333]
    live = [1, 1, 1, 1, 1, 1, 0, 1]            # slot 6 is dead
    worst = 0.0
    for label, Hq, Hkv, D in GROUP_CASES:
        for dtype in ("bfloat16", "float32"):
            for kw in ({}, dict(window=256, logit_cap=30.0),
                       dict(window=256, logit_cap=30.0, is_global=True)):
                q, k, v, lens, livet = decode_case(
                    torch, gen, lengths=lengths, live=live, T_full=2048,
                    dtype=dtype, Hq=Hq, Hkv=Hkv, D=D)
                got = rd.ragged_decode_attention(q, k, v, lens, live=livet,
                                                 **kw)
                want = ragged_decode_attention_ref(q, k, v, lens,
                                                   live=livet, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                dead_zero = bool((got[6] == 0).all().item())
                log(f"ragged_decode {label} (Hq {Hq}, Hkv {Hkv}, D {D}, "
                    f"groups {rd.head_groups(Hq // Hkv)}) {dtype} "
                    f"{kw or 'plain'}: max_abs_err={err:.3e} "
                    f"tol={TOL[dtype]:.0e} dead_row_zero={dead_zero}")
                require(err <= TOL[dtype] and dead_zero and
                        math.isfinite(err), f"ragged_decode {label} {dtype} "
                        f"{kw} disagrees with its plain version")
                if label.startswith("G48") and dtype == "bfloat16":
                    worst = max(worst, err)
    label, Hq, Hkv, D = GROUP_CASES[0]
    q, k, v, lens, livet = decode_case(torch, gen, lengths=lengths,
                                       live=live, T_full=2048,
                                       dtype="bfloat16", Hq=Hq, Hkv=Hkv, D=D)
    ms = time_ms(torch, lambda: rd.ragged_decode_attention(
        q, k, v, lens, live=livet), reps)
    plain_ms = time_ms(torch, lambda: ragged_decode_attention_ref(
        q, k, v, lens, live=livet), max(reps // 4, 3))
    B, T = q.shape[0], k.shape[1]
    qh = q.transpose(1, 2)                                  # (B, Hq, 1, D)
    kh = k.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), reps)
    live_len = sum(n for n, a in zip(lengths, live) if a)
    es = q.element_size()
    nbytes = 2 * live_len * Hkv * D * es + 2 * B * Hq * D * es + 4 * B
    flops = 4 * live_len * Hq * D
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups, gsize = rd.head_groups(Hq // Hkv)
    chunk, n_split = rd.split_plan(B, Hq, Hkv, T, sms)
    scratch = B * Hq * n_split * (2 + D) * 4
    kinds = cuda_launches(torch, lambda: rd.ragged_decode_attention(
        q, k, v, lens, live=livet))
    log(f"ragged_decode {label} timing (B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} "
        f"bf16, live KV rows {live_len}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes / 1e6:.3f} MB); {nbytes / ms / 1e6:.1f} GB/s, "
        f"{flops / ms / 1e9:.1f} TFLOP/s ({card_line()})")
    log(f"ragged_decode {label} grid: {groups} head groups of {gsize}, chunk "
        f"{chunk} rows, {n_split} splits, {B * Hkv * groups * n_split} blocks "
        f"launched; fp32 partials {scratch / 2**20:.2f} MiB; tickets "
        f"{rd.ticket_count(B, Hq, Hkv)}; CUDA launches per call "
        f"{sum(kinds.values())} {kinds}")
    return {"ragged_decode_g48": dict(
        name="ragged_decode_g48", route="cuda",
        source="src/repro_torch/kernels/ragged_decode/csrc/ragged_decode.cu",
        replaces="src/repro/kernels/ragged_decode/kernel.py:86",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)}


def masked_flash_lengths(B: int, S: int):
    """Per-row key counts of a masked flash case: drawn in [1, S] from a
    seed, the last row S itself."""
    import numpy as np
    lens = np.random.default_rng(B * 7919 + S).integers(1, S + 1, size=B)
    lens[-1] = S
    return [int(n) for n in lens]


def run_masked_flash_phase(torch, gen, reps: int):
    """The flash kernel with per-row key padding (``kv_len``) against its
    plain version: B in {1, 8}, S in {1, 63, 64, 65, 1024}, per-row
    lengths in [1, S] and S, H 16, head_dim 64 and 128, causal and not, bf16
    and fp32.  Then timed at seamless-m4t-medium's encoder shapes (B 8, S
    1024, H 16, D 64, bidirectional, bf16, the enc-dec phase's source
    lengths) beside the plain version and SDPA under the same key-padding
    mask; the bound counts the valid score entries only."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    F = torch.nn.functional
    H = 16
    worst = 0.0
    n_cases = 0
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        errs = []
        for B in (1, 8):
            for S in (1, 63, 64, 65, 1024):
                lens = torch.tensor(masked_flash_lengths(B, S),
                                    dtype=torch.int32, device="cuda")
                for D in (64, 128):
                    q, k, v = (torch.randn((B, S, H, D), generator=gen,
                                           device="cuda").to(dt)
                               for _ in range(3))
                    for causal in (False, True):
                        got = fa.flash_attention(q, k, v, causal=causal,
                                                 kv_len=lens)
                        want = flash_attention_ref(q, k, v, causal=causal,
                                                   kv_len=lens)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        n_cases += 1
                        errs.append(err)
                        if not (err <= TOL[dtype] and math.isfinite(err)):
                            raise SystemExit(
                                f"flash_attention kv_len B={B} S={S} D={D} "
                                f"causal={causal} {dtype}: max_abs_err "
                                f"{err:.3e} against its plain version")
        log(f"flash_attention kv_len {dtype}: {len(errs)} cases (B 1/8, S "
            f"1/63/64/65/1024, D 64/128, causal and not), max_abs_err "
            f"{max(errs):.3e} tol {TOL[dtype]:.0e}")
        if dtype == "bfloat16":
            worst = max(errs)
    # timing at the seamless encoder's shapes
    B, S, D = 8, 1024, 64
    src = serving_prompt_lengths()
    lens = torch.tensor(src, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((B, S, H, D), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=False, kv_len=lens)
    want = flash_attention_ref(q, k, v, causal=False, kv_len=lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    require(err <= TOL["bfloat16"], f"masked flash at the encoder's shapes: "
            f"max_abs_err {err:.3e}")
    worst = max(worst, err)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=False,
                                                   kv_len=lens), reps)
    plain_ms = time_ms(torch, lambda: flash_attention_ref(
        q, k, v, causal=False, kv_len=lens), max(reps // 4, 3))
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), reps)
    valid = sum(src)
    es = q.element_size()
    # q read and out written whole; K and V read only where valid
    nbytes = 2 * B * S * H * D * es + 2 * valid * H * D * es + 4 * B
    flops = 4 * D * H * S * valid          # every query row, valid keys
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    kinds = cuda_launches(torch, lambda: fa.flash_attention(
        q, k, v, causal=False, kv_len=lens))
    log(f"flash_attention kv_len timing (B={B} S={S} H={H} D={D} bf16 "
        f"bidirectional, lengths {src}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa with the key-padding mask {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}); {flops / ms / 1e9:.1f} TFLOP/s "
        f"of valid scores (bound {BF16_FLOPS / 1e12:.0f}), sdpa "
        f"{flops / lib_ms / 1e9:.1f}; {fa.grid(B, S, H)} blocks, CUDA "
        f"launches per call {sum(kinds.values())} {kinds} ({card_line()})")
    return {"flash_attention_kv_len": dict(
        name="flash_attention_kv_len", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)}


MLA_HEAD_DIMS = (24, 192, 256)      # deepseek reduced and full qk dims; 256
MLA_H = 16                          # deepseek-v2-lite's heads (G = 1)


def run_mla_flash_phase(torch, gen, reps: int):
    """The flash kernel at MLA's head dims against its plain version: D
    in {24, 192, 256}, bf16 and fp32, H 16, over four cases each: causal
    at S 1024, windowed with a cap at S 200, key-padded (B 3, lengths 200,
    100 and 5) and causal at S 65 (no multiple of the tile); v zero past
    128, as MLA pads it.  Then timed at deepseek-v2-lite's prefill shape
    (B 1, S 1024, H 16, D 192, causal, bf16) beside the plain version and
    SDPA, and at D 24 and 256 for the record."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    F = torch.nn.functional
    H = MLA_H
    cases = (("causal", 1, 1024, {}),
             ("window+cap", 1, 200, dict(window=64, logit_cap=30.0)),
             ("kv_len", 3, 200, dict(kv_len=[200, 100, 5])),
             ("S=65", 1, 65, {}))

    def inputs(B, S, D, dt):
        q, k, v = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        if D > 128:
            v[..., 128:] = 0
        return q, k, v

    worst = 0.0
    for D in MLA_HEAD_DIMS:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            errs = []
            for name, B, S, kw in cases:
                q, k, v = inputs(B, S, D, dt)
                if "kv_len" in kw:
                    kw = dict(kv_len=torch.tensor(kw["kv_len"],
                                                  dtype=torch.int32,
                                                  device="cuda"))
                got = fa.flash_attention(q, k, v, causal=True, **kw)
                want = flash_attention_ref(q, k, v, causal=True, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                errs.append(err)
                if not (err <= TOL[dtype] and math.isfinite(err)):
                    raise SystemExit(
                        f"flash_attention D={D} {name} {dtype}: max_abs_err "
                        f"{err:.3e} against its plain version")
            log(f"flash_attention D={D} {dtype}: "
                f"{[c[0] for c in cases]} max_abs_err "
                + ", ".join(f"{e:.3e}" for e in errs)
                + f" tol {TOL[dtype]:.0e}")
            if D == 192 and dtype == "bfloat16":
                worst = max(errs)
    B, S = 1, 1024
    timed = {}
    for D in MLA_HEAD_DIMS:
        q, k, v = inputs(B, S, D, torch.bfloat16)
        es = q.element_size()
        nbytes = 4 * q.numel() * es             # q, k, v read; out written
        flops = 4 * D * H * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v), reps)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), reps)
        plain_ms = (time_ms(torch, lambda: flash_attention_ref(q, k, v),
                            max(reps // 4, 3)) if D == 192 else None)
        timed[D] = (ms, plain_ms, lib_ms, b_ms, b_by)
        log(f"flash_attention timing D={D} (B={B} S={S} H={H} bf16 causal): "
            f"kernel {ms:.4f} ms, "
            + (f"plain {plain_ms:.4f} ms, " if plain_ms else "")
            + f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s; "
            f"sdpa {flops / lib_ms / 1e9:.1f} TFLOP/s; {fa.grid(B, S, H)} "
            f"blocks ({card_line()})")
    ms, plain_ms, lib_ms, b_ms, b_by = timed[192]
    return {"flash_attention_d192": dict(
        name="flash_attention_d192", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)}


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
    text = src.read_text()
    planned = "int channels, int dtype" in text
    bounded = "void* h_last, void* bounds" in text
    fn.argtypes = ([ctypes.c_void_p] * (9 if bounded else 8)
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int] * (2 if planned else 1)
                   + [ctypes.c_void_p])
    if bounded:
        return fn

    def adapted(*a):
        # this checkout's arguments less the boundary pointer (a[8]) and,
        # for a scan without a plan, the channels per block
        a = a[:8] + a[9:]
        return fn(*a) if planned else fn(*a[:20], *a[21:])
    return adapted


def run_scan_compare(torch, others, reps: int = 20):
    """``--scan-baseline DIR [DIR ...]``: the scan of each other checkout
    (DIR: its root) beside this checkout's, timed by ``scan_sweep`` on one
    card in turns (the others, this checkout twice, the others), each
    first compared with the plain version at S = 1024 (this checkout's
    must agree) and with this checkout's serving instance, which every
    other checkout's output must equal bitwise, as this checkout's
    training instance (boundary states on) must."""
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
    mine = ms.mamba_scan(x, delta, bm, cm, a_log, d_vec)
    trained = ms.mamba_scan(x, delta, bm, cm, a_log, d_vec, bounds=True)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(mine, trained[:2])),
            "this checkout's scan with boundary states differs from its "
            "serving instance")
    log("this checkout: the training instance's y and last state equal "
        "the serving instance's bitwise")
    olds = [(str(o), build_other_scan(o)) for o in others]
    this = [("this checkout", new)]
    try:
        for label, fn in olds + this + this + olds:
            ms._scan_fn = lambda fn=fn: fn
            got = ms.mamba_scan(x, delta, bm, cm, a_log, d_vec)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            ok = all(agree(g, w, TOL["float32"]) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, mine))
            require(ok, f"{label}: scan disagrees with its plain version")
            log(f"{label}: S=1024 max_abs_err {err:.3e}, agrees {ok}, "
                f"bitwise equal to this checkout's serving scan {same}")
            require(same, f"{label}: scan differs from this checkout's "
                    f"serving instance")
            scan_sweep(torch, gen, d_in, R, N, reps, label=label,
                       show_plan=fn is new)
    finally:
        ms._scan_fn = orig


def build_other_flash(checkout: Path):
    """Another checkout's flash kernel (its flash_attention.cu and
    common.cu, built into build/other/<name>/) as a function with this
    checkout's C signature; a kernel whose C function takes no key
    padding drops it (its callers pass none)."""
    import ctypes
    from repro_torch.kernels import _build
    kdir = checkout.resolve() / "src" / "repro_torch" / "kernels"
    src = kdir / "flash_attention" / "csrc" / "flash_attention.cu"
    lib_path = ROOT / "build" / "other" / checkout.name / "libflash.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
                    "-shared", "-o", str(lib_path), str(src),
                    str(kdir / "common" / "csrc" / "common.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).flash_attention
    fn.restype = ctypes.c_int
    padded = "const int* kv_len" in src.read_text()
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
    fn.argtypes = ([P] * 4 + [I] * 5 + [L] * 12 + [I] * 3 + [F]
                   + ([P, F] if padded else []) + [I, P])
    return fn if padded else (lambda *a: fn(*a[:25], *a[27:]))


def build_other_flash_bwd(checkout: Path):
    """Another checkout's flash backward (its flash_attention_bwd.cu and
    common.cu, built into build/other/<name>/) as a function with this
    checkout's C signature; a backward whose C function takes no window
    drops it (the comparison passes none)."""
    import ctypes
    from repro_torch.kernels import _build
    kdir = checkout.resolve() / "src" / "repro_torch" / "kernels"
    src = kdir / "flash_attention" / "csrc" / "flash_attention_bwd.cu"
    lib_path = ROOT / "build" / "other" / checkout.name / "libflash_bwd.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
                    "-shared", "-o", str(lib_path), str(src),
                    str(kdir / "common" / "csrc" / "common.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).flash_attention_bwd
    fn.restype = ctypes.c_int
    windowed = "int window, int glob" in src.read_text()
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * (
        10 if windowed else 8) + [ctypes.c_void_p])
    # this checkout's arguments: ..., causal (a[16]), window, glob, n_split
    return fn if windowed else (lambda *a: fn(*a[:17], *a[19:]))


def run_flash_bwd_compare(torch, others, reps: int = 20):
    """The flash backward of each other checkout beside this checkout's
    without a window, at minitron-4b's training shape (B 4, S 1024, 24 on
    8, D 128) and granite's multi-query one (B 1, 48 on 1: the split and
    its fold), bf16, in turns; each output must equal this checkout's
    bitwise."""
    from repro_torch.kernels.flash_attention import ops as fa
    orig = fa._bwd_fn
    new = orig()
    gen = torch.Generator(device="cuda").manual_seed(2)
    olds = [(str(o), build_other_flash_bwd(o)) for o in others]
    this = [("this checkout", new)]
    try:
        for B, Hq, Hkv in ((4, 24, 8), (1, 48, 1)):
            q, dout = (torch.randn((B, 1024, Hq, 128), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(2))
            k, v = (torch.randn((B, 1024, Hkv, 128), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            out, lse = fa.flash_attention_lse(q, k, v)
            fa._bwd_fn = lambda: new
            want = fa.flash_attention_bwd(q, k, v, out, dout, lse)
            times = {}
            for label, fn in olds + this + this + olds:
                fa._bwd_fn = lambda fn=fn: fn
                got = fa.flash_attention_bwd(q, k, v, out, dout, lse)
                torch.cuda.synchronize()
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{label}: flash backward differs from this "
                        f"checkout's")
                times.setdefault(label, []).append(time_ms(
                    torch, lambda: fa.flash_attention_bwd(
                        q, k, v, out, dout, lse), reps))
            log(f"flash backward causal S=1024 B={B} Hq={Hq} Hkv={Hkv} D=128 "
                f"bf16, no window, bitwise equal; ms per turn: "
                + "; ".join(f"{lab} {[round(t, 5) for t in ts]}"
                            for lab, ts in times.items())
                + f" ({card_line()})")
    finally:
        fa._bwd_fn = orig


def run_flash_compare(torch, others, reps: int = 50):
    """``--flash-baseline DIR [DIR ...]``: the causal flash kernel of each
    other checkout (DIR: its root) beside this checkout's, at a 1024-token
    prompt (minitron-4b's heads, bf16) for B = 1 and 4, on one card in
    turns (the others, this checkout twice, the others, this checkout);
    each output must equal this checkout's bitwise."""
    from repro_torch.kernels.flash_attention import ops as fa
    orig = fa._fn
    new = orig()
    gen = torch.Generator(device="cuda").manual_seed(1)
    olds = [(str(o), build_other_flash(o)) for o in others]
    this = [("this checkout", new)]
    try:
        for B in (1, 4):
            q = torch.randn((B, 1024, 24, 128), generator=gen,
                            device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((B, 1024, 8, 128), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            fa._fn = lambda: new
            want = fa.flash_attention(q, k, v)
            times = {}
            for label, fn in olds + this + this + olds + this:
                fa._fn = lambda fn=fn: fn
                got = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"{label}: causal flash differs from this checkout's")
                times.setdefault(label, []).append(time_ms(
                    torch, lambda: fa.flash_attention(q, k, v), reps))
            log(f"flash causal S=1024 B={B} Hq=24 Hkv=8 D=128 bf16, ms per "
                f"turn: " + "; ".join(f"{lab} {[round(t, 5) for t in ts]}"
                                      for lab, ts in times.items())
                + f" ({card_line()})")
    finally:
        fa._fn = orig


def mamba_step_check(torch, gen, cfg, dtype: str, live, dead: int):
    """One Mamba step kernel launch at ``cfg``'s widths against its plain
    version, on 8 slots of which ``dead`` is dead: out, conv and h within
    ``TOL[dtype]`` (abs + rel), the dead row zero and its state bit-
    unchanged.  Fails the run on a miss; returns (the three max abs
    errors, args, x1, conv, h)."""
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import mamba_step_ref
    from repro_torch.models import ssm as S
    d_in, _, N, w = S.dims(cfg)
    B = live.shape[0]
    dt = getattr(torch, dtype)
    p = S.mamba_init(gen, cfg, dtype=dt, device="cuda")
    args = [p[k] for k in MAMBA_ORDER]
    x1 = torch.randn((B, 1, cfg.d_model), generator=gen,
                     device="cuda").to(dt)
    conv0 = torch.randn((B, w - 1, d_in), generator=gen, device="cuda").to(dt)
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
    log(f"mamba_step {cfg.name} widths {dtype} B={B} (slot {dead} dead): "
        f"max_abs_err out {errs[0]:.3e} conv {errs[1]:.3e} h {errs[2]:.3e}, "
        f"tol {tol:.0e} abs + rel; dead row zero and bit-unchanged "
        f"{dead_ok}")
    require(ok and dead_ok, f"mamba_step {cfg.name} {dtype} disagrees with "
            f"its plain version")
    return errs, args, x1, conv, h


def mamba_scan_check(torch, gen, S_len: int, dtype: str, d_in: int, R: int,
                     N: int, a_log, d_vec):
    """One scan launch of an S_len-token prompt at d_in channels against
    its plain version (y and h fp32 within ``TOL["float32"]``, abs + rel).
    Fails the run on a miss; returns the larger max abs error."""
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    x, delta, bm, cm = scan_inputs(torch, gen, S_len, d_in, R, N,
                                   getattr(torch, dtype))
    y, h_last = ms.mamba_scan(x, delta, bm, cm, a_log, d_vec)
    want_y, want_h = mamba_scan_ref(x, delta, bm, cm, a_log, d_vec)
    torch.cuda.synchronize()
    tol = TOL["float32"]
    err_y = (y - want_y).abs().max().item()
    err_h = (h_last - want_h).abs().max().item()
    log(f"mamba_scan S={S_len} d_in={d_in} {dtype} inputs (y, h fp32): "
        f"max_abs_err y {err_y:.3e} h {err_h:.3e}, tol {tol:.0e} abs + rel")
    require(agree(y, want_y, tol) and agree(h_last, want_h, tol),
            f"mamba_scan S={S_len} d_in={d_in} {dtype} disagrees with its "
            f"plain version")
    return max(err_y, err_h)


def run_ssm_kernel_phase(torch, reps: int = 20):
    """The Mamba step and selective-scan kernels against their plain
    versions at falcon-mamba-7b widths (d_model 4096, d_in 8192, N 16,
    dt_rank 256, conv width 4), timed there; then at hymba-1.5b's (d_model
    1600, d_in 3200, dt_rank 100), whose x_proj (N 132) and dt_proj (K 100)
    take the step's CUDA-core product, with the scan at d_in 3200 over
    hymba's prompt lengths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
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
        errs, args, x1, conv, h = mamba_step_check(torch, gen, cfg, dtype,
                                                   live, dead)
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
        del args

    # -- the step at hymba-1.5b's widths: the CUDA-core product route -------
    hcfg = get_config("hymba-1.5b")
    hd_in, hR, hN, _ = S.dims(hcfg)
    sms = _build.sm_count(0)
    for dtype in ("bfloat16", "float32"):
        errs, args, *_ = mamba_step_check(torch, gen, hcfg, dtype, live, dead)
        x_proj, dt_proj = args[3], args[4]
        routes = (ms._product_plan(B, hd_in, hR + 2 * hN, hd_in, 0, x_proj,
                                   sms).route,
                  ms._product_plan(B, hR, hd_in, hR + 2 * hN, 0, dt_proj,
                                   sms).route)
        log(f"mamba_step hymba-1.5b {dtype}: x_proj {tuple(x_proj.shape)} "
            f"and dt_proj {tuple(dt_proj.shape)} routes {routes} (CUDA-core "
            f"product {ms._FMA})")
        require(routes == (ms._FMA, ms._FMA), f"mamba_step hymba-1.5b "
                f"{dtype}: x_proj or dt_proj left the CUDA-core product")
        if dtype == "bfloat16":
            worst = max(worst, *errs)
        del args
    results["mamba_step"]["max_abs_err"] = worst

    # -- prefill selective scan --------------------------------------------
    worst = 0.0
    a_log, d_vec = scan_params(torch, d_in, N)
    for S_len, dtype in ((1, "bfloat16"), (37, "bfloat16"), (200, "bfloat16"),
                         (1024, "bfloat16"), (200, "float32")):
        worst = max(worst, mamba_scan_check(torch, gen, S_len, dtype, d_in,
                                            R, N, a_log, d_vec))
    x, delta, bm, cm = scan_inputs(torch, gen, 1024, d_in, R, N,
                                   torch.bfloat16)
    plain_ms = time_ms(torch, lambda: mamba_scan_ref(
        x, delta, bm, cm, a_log, d_vec), 3)
    del x, delta, bm, cm
    # hymba's d_in 3200 at its prompts' lengths (1500 and 1200 serving, 1100
    # in the reference check, the shorter ones 100-1000)
    ha_log, hd_vec = scan_params(torch, hd_in, hN)
    for S_len, dtype in ((37, "bfloat16"), (1100, "bfloat16"),
                         (1500, "bfloat16"), (1100, "float32")):
        worst = max(worst, mamba_scan_check(torch, gen, S_len, dtype, hd_in,
                                            hR, hN, ha_log, hd_vec))
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


def serving_prompt_lengths():
    """The lengths of ``serving_prompts``."""
    import numpy as np
    return [int(n) for n in np.random.default_rng(0).integers(100, 1001,
                                                               size=8)]


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
    return top2_margin(model, logits)


def top2_margin(model, logits) -> float:
    """The top-2 margin of (1, V) logits relative to their largest |value|,
    over the vocabulary only: the padding columns hold -1e30."""
    real = logits.float()[..., :model.cfg.vocab_size]
    top2 = real.topk(2, dim=-1).values[0]
    return (top2[0] - top2[1]).item() / real.abs().max().item()


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
# the enc-dec and encoder workload classes, and the four-class fleet
# ---------------------------------------------------------------------------

# seamless-m4t-medium through EncDecEngine: 8 slots, sources up to 1024
# frames on a four-bucket ladder, [bos] decoder prompts, 32 new tokens
ENCDEC_SERVE = dict(max_slots=8, max_len=64, max_src_len=1024,
                    len_buckets=(128, 256, 512), eos_id=-1, use_kernels=True)
ENCDEC_KERNELS = ("ragged_decode", "flash_attention", "flash_attention_kv_len")
ENCDEC_NEW = 32
# qwen2.5-32b through EncoderEngine at its published widths, 16 of its 64
# layers (all 64 are about 65 GB of bf16 weights); 16 jobs of 64-2048
# tokens on the ladder (512, 1024, 2048)
ENCODER_LAYERS = 16
ENCODER_SERVE = dict(max_slots=8, max_len=2048, len_buckets=(512, 1024),
                     use_kernels=True)
# the launcher's flash-crowd scenario over its MIXED_FLEET on 8 CUs: paged
# KV at 0.4 of the slots' worst case (8-row pages, 64-row slots: page
# exhaustion preempts), 12 requests per tenant, 32 new tokens
MIXED_ARGS = ["--fabric", "--scenario", "flash-crowd", "--device", "cuda",
              "--num-cus", "8", "--kv-frac", "0.4", "--kv-page-rows", "8",
              "--max-slots", "8", "--max-len", "64", "--requests", "12",
              "--max-new-tokens", "32", "--layers",
              f"qwen2.5-32b={ENCODER_LAYERS}", "--log-every", "0"]
MIXED_KERNELS = ("ragged_decode", "flash_attention", "flash_attention_kv_len",
                 "mamba_step", "mamba_scan")


def padded_sources(torch, sources, S: int):
    """(B, S) right-padded int32 tokens and (B,) int32 lengths, on the
    card."""
    import numpy as np
    toks = np.zeros((len(sources), S), np.int32)
    for i, src in enumerate(sources):
        toks[i, :len(src)] = src
    lens = np.array([len(x) for x in sources], np.int32)
    return (torch.from_numpy(toks).cuda(), torch.from_numpy(lens).cuda())


def encdec_path_logits(torch, paths, sources, bos: int, *, steps: int = 5):
    """Per source, fp32 logits of each path after the [bos] prefill and
    after each of ``steps`` decode steps, every path fed the last path's
    argmax.  A path is (model, params, use_kernels); the sources are
    encoded together, right-padded to 1024 with their lengths.  The logits
    cover the vocabulary only (seamless pads 256206 to 256256 columns,
    which hold -1e30)."""
    toks, lens = padded_sources(torch, sources, 1024)
    encs = [m.encode(p, {"tokens": toks}, lens=lens, use_kernels=kern)
            for m, p, kern in paths]
    out = []
    for b, src in enumerate(sources):
        bos_t = torch.full((1, 1), bos, dtype=torch.int32, device="cuda")
        logits, caches = [None] * len(paths), [None] * len(paths)
        for i, (m, p, kern) in enumerate(paths):
            logits[i], caches[i] = m.prefill(
                p, {"tokens": bos_t}, m.init_cache(1, steps + 4,
                                                   src_len=1024),
                enc_out=encs[i][b:b + 1], src_len=len(src),
                use_kernels=kern)
        V = paths[0][0].cfg.vocab_size
        rows = [[x.float()[..., :V] for x in logits]]
        for _ in range(steps):
            nxt = logits[-1].argmax(-1).to(torch.int32)[:, None]
            for i, (m, p, kern) in enumerate(paths):
                logits[i], caches[i] = m.decode_step(p, caches[i], nxt,
                                                     use_kernels=kern)
            rows.append([x.float()[..., :V] for x in logits])
        out.append(rows)
    return out


def encdec_reference_check(torch, path_a, path_b, sources, bos, *, tol,
                           label):
    """Path a (kernels) against path b (plain), both fed b's argmax, per
    source: max|a - b| / max|b| within ``tol`` at every position; the
    argmax may part only where b's top-2 margin is below ARGMAX_MARGIN
    (counted).  Returns (largest relative difference, near-ties)."""
    worst, ties = 0.0, 0
    for b, rows in enumerate(encdec_path_logits(torch, (path_a, path_b),
                                                sources, bos)):
        for step, (a, ref) in enumerate(rows):
            rel = rel_err(a, ref)
            same, margin, ok = argmax_check(a, ref, ARGMAX_MARGIN)
            ties += not same
            require(math.isfinite(rel) and rel <= tol and ok,
                    f"{label}: source {b} step {step}: max|dlogit|/max|"
                    f"logit| {rel:.3e} (tol {tol:.0e}), argmax equal "
                    f"{same}, top-2 margin {margin:.3e}")
            worst = max(worst, rel)
    log(f"{label}: {len(sources)} sources x 6 positions, max|dlogit|/max|"
        f"logit| = {worst:.3e} (tol {tol:.0e}); argmax parted at {ties} "
        f"near-tie(s) (top-2 margin < {ARGMAX_MARGIN:.0e})")
    return worst, ties


def encode_groups(sources, ladder):
    """The engine's admission encodes of ``sources``: (bucket, sources)
    per group of each source's own smallest fitting bucket."""
    from repro_torch.workloads.base import pick_bucket
    groups = {}
    for src in sources:
        groups.setdefault(pick_bucket(ladder, len(src)), []).append(src)
    return sorted(groups.items())


def run_encdec_phase(torch):
    """Full-width seamless-m4t-medium (12 + 12 layers, random bf16 weights
    from seed 0) through ``EncDecEngine``: 8 sources of 100-1000 tokens,
    [bos] decoder prompts, 32 new tokens, 8 slots, on four fresh engines in
    turns (decode steps as CUDA graphs, then eager), each warmed by
    ``warm_compile(None)`` before the clock.  Logs encode (the batched
    admission encodes' device time) and prefill ms, decode p50, tokens/s,
    captures on the serving path (0 with graphs) and the launches of the
    three attention kernels; streams must be equal.  Then the kernel path's
    logits against the plain path's, in bf16 (5e-2 of the largest |logit|)
    and on an fp32 copy of the weights (1e-3), the argmax parting only at
    counted near-ties; between the two, the graph run under the profiler
    (device time by kind, busy share).  Returns the first graph run's
    launches."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.workloads import EncDecEngine, ServeConfig
    from repro_torch.workloads.base import length_buckets
    cfg = get_config("seamless-m4t-medium")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"seamless-m4t-medium: {cfg.param_count() / 1e9:.2f} B params "
        f"({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers), "
        f"random bf16 weights in {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(**ENCDEC_SERVE)
    sources = serving_prompts(cfg)
    warm = EncDecEngine(model, params, scfg)
    for src in sources:
        warm.submit(src, max_new_tokens=2)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    runs = [serving_run(torch, EncDecEngine, model, params, scfg, sources,
                        ENCDEC_NEW, ENCDEC_KERNELS, graphs)
            for graphs in (True, False, True, False)]
    ladder = length_buckets(scfg.len_buckets, scfg.max_src_len)
    groups = encode_groups(sources, ladder)
    enc_ms = 0.0
    for sb, group in groups:
        toks, lens = padded_sources(torch, group + [[1]] * (
            scfg.max_slots - len(group)), sb)
        lens[len(group):] = 0               # rows that hold no job
        enc_ms += time_ms(torch, lambda: model.encode(
            params, {"tokens": toks}, lens=lens), reps=5)
    card = card_line()
    L, Le = cfg.num_layers, cfg.encoder_layers
    for run in runs:
        launches = run["launches"]
        mean, lo, hi = run["prefill"]
        log(f"enc-dec seamless-m4t-medium {run['label']}: sources "
            f"{[len(x) for x in sources]} in buckets "
            f"{[(sb, len(g)) for sb, g in groups]}, {ENCDEC_NEW} new tokens "
            f"each; encode {enc_ms:.3f} ms on the device (the admission's "
            f"batched encodes); prefill ms per request mean {mean:.2f} (min "
            f"{lo:.2f}, max {hi:.2f}, the first of a batch waits on its "
            f"encode); decode ms per step p50 {run['p50']:.3f}; "
            f"{run['tokens']} tokens in {run['wall']:.3f} s = "
            f"{run['tokens_s']:.1f} tokens/s; peak memory "
            f"{run['peak_gib']:.2f} GiB; graph captures on the serving path "
            f"{run['path_captures']}; covering steps {run['covering']}; "
            f"graphs (launches captured, replays) {run['graphs']}; launches "
            f"{launches} ({card})")
        steps = run["decode_steps"]
        require(run["prefills"] == 8, f"{run['prefills']} prefills, want 8")
        require(launches["ragged_decode"] >= 2 * L * steps > 0,
                f"ragged_decode launched {launches} for {steps} steps")
        require(launches["flash_attention"] >= L * 8,
                f"flash_attention launched {launches} for 8 prefills")
        require(launches["flash_attention_kv_len"] >= Le * len(groups),
                f"flash_attention_kv_len launched {launches} for "
                f"{len(groups)} encodes")
        require(len(run["streams"]) == 8 and all(
            len(t) == ENCDEC_NEW and all(0 <= v < cfg.vocab_size for v in t)
            for t in run["streams"]), "enc-dec streams incomplete")
    for graph, eager in (runs[0:2], runs[2:4]):
        require(graph["path_captures"] == 0,
                f"{graph['path_captures']} captures on the serving path")
        require(bool(graph["graphs"]) and not eager["graphs"],
                "the graph run replayed no graph, or the eager run did")
        require(graph["streams"] == eager["streams"] == runs[0]["streams"],
                "enc-dec graph and eager streams differ")
    log("enc-dec: streams of the four runs equal, token for token")
    profile_serving(
        torch, lambda: make_engine(torch, EncDecEngine, model, params, scfg,
                                   True)[0],
        lambda e: serve(torch, e, sources, ENCDEC_NEW),
        "seamless-m4t-medium graphs", ("ragged_decode", "flash_attention"),
        runs[0]["wall"], runs[0]["launches"]["ragged_decode"],
        "ragged_decode", None)
    encdec_reference_check(torch, (model, params, True),
                           (model, params, False), sources, scfg.bos_id,
                           tol=LOGIT_REL_TOL,
                           label="enc-dec reference check bf16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32, "cuda")
    params32 = to_fp32(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    encdec_reference_check(torch, (model32, params32, True),
                           (model32, params32, False), sources, scfg.bos_id,
                           tol=FP32_LOGIT_REL_TOL,
                           label="enc-dec reference check fp32")
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_kv_len":
            runs[0]["launches"]["flash_attention_kv_len"]}


# ---------------------------------------------------------------------------
# MLA and MoE: full-width deepseek-v2-lite-16b through the decode engine
# ---------------------------------------------------------------------------

DEEPSEEK_SERVE = dict(max_slots=8, max_len=2048, eos_id=-1, use_kernels=True)
DEEPSEEK_NEW = 32
DEEPSEEK_KERNELS = ("flash_attention_d192",)


def routing_partings(torch, run, n_moe: int):
    """Call ``run()``, which runs two paths in turns as ``path_logits``
    does (each position: path a's forward, then path b's, ``n_moe`` MoE
    layers each), while the router's top-k picks are recorded.  Returns
    (run's result, decisions, partings): a parting is a (token, layer)
    whose top-k set differs between the two paths."""
    from repro_torch.models import moe as M
    seen = []
    routing = M._routing

    def record(p, mo, xg):
        out = routing(p, mo, xg)
        seen.append(out[1].sort(dim=-1).values)
        return out

    M._routing = record
    try:
        result = run()
    finally:
        M._routing = routing
    require(len(seen) % (2 * n_moe) == 0,
            f"{len(seen)} routings recorded for two paths of {n_moe} layers")
    decisions = partings = 0
    for blk in range(0, len(seen), 2 * n_moe):
        for a, b in zip(seen[blk:blk + n_moe], seen[blk + n_moe:blk + 2 * n_moe]):
            differ = (a != b).any(-1)
            decisions += differ.numel()
            partings += int(differ.sum().item())
    return result, decisions, partings


@contextlib.contextmanager
def routing_pin(picks: dict, mode: str):
    """A context in which every MoE layer's routing is recorded into,
    pinned to, or compared with ``picks``, keyed by the layer's router
    tensor: the serving check pins each position's forward to the plain
    path's experts, the training checks pin the forward and the remat
    recompute inside the backward alike.  "record": the layer's first
    routing in the context stores its top-k experts; "pin": every routing
    of the layer takes the stored experts, gates renormalised from its own
    probabilities; "free": the layer routes as its own.  In "pin" and
    "free" the context's value counts, over each layer's first routing,
    the (token, layer) picks and those whose own top-k set parts from the
    stored one."""
    from repro_torch.models import moe as M
    routing = M._routing
    st = {"picks": 0, "parted": 0}
    first = set()

    def routed(p, mo, xg):
        gates, idx, probs = routing(p, mo, xg)
        key = p["router"].data_ptr()
        if mode == "record":
            picks.setdefault(key, idx)
            return gates, idx, probs
        want = picks[key]
        if key not in first:
            first.add(key)
            differ = (idx.sort(-1).values != want.sort(-1).values).any(-1)
            st["picks"] += differ.numel()
            st["parted"] += int(differ.sum().item())
        if mode == "free":
            return gates, idx, probs
        g = probs.gather(-1, want)
        return g / g.sum(-1, keepdim=True), want, probs

    M._routing = routed
    try:
        yield st
    finally:
        M._routing = routing


def moe_reference_check(torch, path_a, path_b, *, tol, label, n_moe,
                        S: int = 100, steps: int = 5):
    """Path a (kernels) against path b (plain) on one S-token prompt (seed
    2) and ``steps`` decode steps, each fed b's argmax, with the router
    pinned (``routing_pin``): at each position b runs first and records its
    top-k experts per MoE layer, then a routes to those experts, its gates
    renormalised from its own probabilities.  a's logits must lie within
    ``tol`` of b's (relative to max|b|), the argmax parting only where b's
    top-2 margin is below min(tol, ARGMAX_MARGIN) (counted).  Where a's
    own top-k would have parted from b's is counted and logged, not
    failed: a near-tie among the experts flips under rounding at other
    points, and a flip moves a token's output by a whole expert.  The
    unpinned run (each path its own routing, ``path_logits``) is logged
    beside, not failed.  Returns the largest pinned relative difference."""
    (ma, pa, ka), (mb, pb, kb) = path_a, path_b
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(1, mb.cfg.vocab_size, (1, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    ca, cb = ma.init_cache(1, S + steps + 3), mb.init_cache(1, S + steps + 3)
    worst, parted = 0.0, 0
    picks_run = parted_run = 0
    nxt = None
    for step in range(steps + 1):
        picks = {}
        with routing_pin(picks, "record"):
            if nxt is None:
                lb, cb = mb.prefill(pb, {"tokens": toks}, cb, use_kernels=kb)
            else:
                lb, cb = mb.decode_step(pb, cb, nxt, use_kernels=kb)
        with routing_pin(picks, "pin") as st:
            if nxt is None:
                la, ca = ma.prefill(pa, {"tokens": toks}, ca, use_kernels=ka)
            else:
                la, ca = ma.decode_step(pa, ca, nxt, use_kernels=ka)
        require(len(picks) == n_moe and st["picks"] > 0,
                f"{label}: {len(picks)} recorded routings, want {n_moe}")
        picks_run += st["picks"]
        parted_run += st["parted"]
        a, b = la.float(), lb.float()
        rel = rel_err(a, b)
        same, margin, ok = argmax_check(a, b, min(tol, ARGMAX_MARGIN))
        parted += not same
        log(f"{label} step {step} (routing pinned): max|dlogit|/max|logit| "
            f"= {rel:.3e} (tol {tol:.0e}), argmax equal {same}, top-2 "
            f"margin of b {margin:.3e}")
        require(math.isfinite(rel) and rel <= tol and ok,
                f"{label}: the two paths disagree at step {step}")
        worst = max(worst, rel)
        nxt = lb.argmax(-1).to(torch.int32)[:, None]
    free, decisions, free_parted = routing_partings(
        torch, lambda: path_logits(torch, (path_a, path_b), steps=steps),
        n_moe)
    free_rel = max(rel_err(a, b) for a, b in free)
    log(f"{label}: largest {worst:.3e} with the routing pinned; argmax "
        f"partings {parted} of {steps + 1} positions; a's own top-k parted "
        f"from b's at {parted_run} of {picks_run} (token, layer) picks "
        f"over the run; unpinned (each path its own routing): largest {free_rel:.3e}, routing parted at "
        f"{free_parted} of {decisions} picks (logged, not failed)")
    return worst


def forced_logits(model, params, use_kernels: bool, tokens):
    """fp32 logits over the vocabulary after prefilling ``tokens[:, :100]``
    and after each later token, fed as given (the same positions for every
    path)."""
    V = model.cfg.vocab_size
    cache = model.init_cache(1, tokens.shape[1] + 2)
    logits, cache = model.prefill(params, {"tokens": tokens[:, :100]},
                                  cache, use_kernels=use_kernels)
    out = [logits.float()[..., :V]]
    for i in range(100, tokens.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                          use_kernels=use_kernels)
        out.append(logits.float()[..., :V])
    return out


def to_fp32_in_place(tree):
    """Cast every tensor of a param tree to fp32, leaf by leaf, so that the
    bf16 copy of each is freed as the next is made."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for key, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            to_fp32_in_place(leaf)
        else:
            tree[key] = leaf.float()


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def graph_ms(torch, fn, reps: int = 10) -> float:
    """Device ms of ``fn`` captured as one CUDA graph and replayed, as a
    decode step runs it, timed as ``time_ms`` times a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return time_ms(torch, graph.replay, reps)


def deepseek_step_breakdown(torch, model, params, scfg, reps: int = 10):
    """One decode step of 8 live slots at 900 rows (a filled engine, as
    ``covering_cost`` builds it) as a graph at its exact bound (928),
    timed whole beside its bound (every weight read once, the experts
    included, and the latent rows); then each module of one layer at the
    step's shapes, each captured as a graph of its own (L2 flushed before
    each replay), times its layer count: the MoE layer less its experts
    (router, capacity, one-hot dispatch and combine), the routed experts'
    products, the shared experts, MLA's absorbed step, and the prologue's
    dense FFN."""
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.workloads import DecodeEngine
    cfg = model.cfg
    engine, _ = filled_engine(torch, DecodeEngine, model, params, scfg, 900,
                              scfg.max_len)
    pool = engine._pool
    pool.inputs[2].fill_(1)                     # every slot live
    kv_bound = 928
    step = engine._build_decode(pool, (kv_bound,))
    torch.cuda.synchronize()            # the capture ran on engine streams
    step_ms = time_ms(torch, step, reps=reps)
    dec = params["decoder"]
    n_moe, n_pro = len(dec["layers"]), len(dec["prologue"])
    wbytes = (param_bytes(dec) + param_bytes(params["lm_head"]))
    lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    kbytes = 8 * 900 * lat * 2 * cfg.num_layers
    b_ms, _ = bound(wbytes + kbytes, 0.0, "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = torch.randn((8, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lp = dec["layers"][0]
    moe_ms = graph_ms(torch, lambda: M.moe_apply(lp["moe"], cfg, h), reps)
    E, C = cfg.moe.num_experts, M.capacity(cfg.moe, 1)
    xe = torch.randn((E, 8 * C, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    experts_ms = graph_ms(torch, lambda: M._expert_ffn(
        lp["moe"]["experts"], cfg, xe), reps)
    shared_ms = graph_ms(torch, lambda: M.ffn_apply(lp["moe"]["shared"], cfg,
                                                   h), reps)
    attn = engine.cache["scanned"]["attn"]
    lc = {"ckv": attn["ckv"][0], "krope": attn["krope"][0]}
    pos = engine.cache["pos"].clone()
    mla_ms = graph_ms(torch, lambda: A.mla_step(
        lp["attn"], cfg, h, lc, pos, use_kernels=True, kv_bound=kv_bound),
        reps)
    dense_ms = graph_ms(torch, lambda: M.ffn_apply(dec["prologue"][0]["ffn"],
                                                  cfg, h), reps)
    parts = {"MoE dispatch (router, capacity, one-hots, combine)":
             n_moe * (moe_ms - experts_ms - shared_ms),
             "routed experts (64 x 3 products)": n_moe * experts_ms,
             "shared experts": n_moe * shared_ms,
             "MLA latent attention (absorbed step)": cfg.num_layers * mla_ms,
             "prologue dense FFN": n_pro * dense_ms}
    log(f"deepseek-v2-lite-16b decode step (graph, 8 slots at 900 rows, "
        f"bound {kv_bound}): {step_ms:.3f} ms, bound {b_ms:.3f} ms (bytes: "
        f"{wbytes / 1e9:.2f} GB of weights, every expert, and "
        f"{kbytes / 1e9:.3f} GB of latents at 3.35 TB/s; {step_ms / b_ms:.2f}"
        f"x); by module, one layer's graph x its count (ms per step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; the rest (embedding, norms, residuals, head, argmax, graph "
        f"gaps) {step_ms - sum(parts.values()):.3f}; routed experts alone "
        f"{n_moe * experts_ms / step_ms:.2f} of the step ({card_line()})")
    del engine, step
    return step_ms, b_ms


def run_deepseek_phase(torch):
    """Full-width deepseek-v2-lite-16b (27 layers: one dense prologue
    layer, then 26 MoE layers of 64 routed experts top-6 and 2 shared;
    MLA attention), random bf16 weights from seed 0, through
    ``DecodeEngine`` with the kernels on: phase 3's 8 prompts, 32 new
    tokens, 8 slots, ``max_len`` 2048, on fresh engines in turns (decode
    steps as CUDA graphs, then eager), each warmed by
    ``warm_compile(None)``.  Prefill runs the flash kernel at D = 192 (q
    nope and rope, v padded); the rest is stock torch, as the reference
    computes it outside any kernel.  Logs prefill ms, decode p50,
    tokens/s, peak memory (< 80 GiB), captures on the serving path (0 with
    graphs) and the flash launches (27 per prefill); streams must be
    equal.  Then the step breakdown, the busy share under the profiler,
    and the kernel path's logits against the plain path's with the router
    pinned to the plain path's experts (``moe_reference_check``), in bf16
    (5e-2) and, the weights cast to fp32 in place, in fp32 (1e-3), both at
    full depth, argmax partings only at counted near-ties; routing
    partings and the unpinned distance are logged, as is the bf16 model's
    own rounding floor (each bf16 path's distance from the fp32 plain
    path on fixed tokens).  Frees its weights before returning the graph
    run's launches."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.workloads import DecodeEngine, ServeConfig
    cfg = get_config("deepseek-v2-lite-16b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"deepseek-v2-lite-16b: {cfg.param_count() / 1e9:.2f} B params "
        f"({cfg.num_layers} layers, {cfg.moe.first_k_dense} dense prologue; "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
        f"{cfg.moe.num_shared_experts} shared; MLA rank "
        f"{cfg.mla.kv_lora_rank}), random bf16 weights "
        f"({param_bytes(params) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(**DEEPSEEK_SERVE)
    engine = DecodeEngine(model, params, scfg)
    log(f"deepseek-v2-lite-16b admission: {engine._per_token_elems} latent "
        f"elements per token over {cfg.num_layers} layers "
        f"(kv_lora_rank + qk_rope_head_dim = "
        f"{cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim} per layer)")
    require(engine._per_token_elems == 15552,
            f"per-token cache elements {engine._per_token_elems}, want 15552")
    del engine
    prompts = serving_prompts(cfg)
    warm = DecodeEngine(model, params, scfg)
    for p in prompts:
        warm.submit(p, max_new_tokens=2)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    runs = [serving_run(torch, DecodeEngine, model, params, scfg, prompts,
                        DEEPSEEK_NEW, DEEPSEEK_KERNELS, graphs)
            for graphs in (True, False)]
    card = card_line()
    L = cfg.num_layers
    for run in runs:
        launches = run["launches"]
        mean, lo, hi = run["prefill"]
        log(f"serving deepseek-v2-lite-16b ({run['engine']}, max_len "
            f"{scfg.max_len}, {run['label']}): prompts "
            f"{[len(p) for p in prompts]}, {DEEPSEEK_NEW} new tokens each; "
            f"prefill ms per request mean {mean:.2f} (min {lo:.2f}, max "
            f"{hi:.2f}); decode ms per step p50 {run['p50']:.3f}; "
            f"{run['tokens']} tokens in {run['wall']:.3f} s = "
            f"{run['tokens_s']:.1f} tokens/s; peak memory "
            f"{run['peak_gib']:.2f} GiB; warm_compile built "
            f"{run['warm'][0]} in {run['warm'][1]:.3f} s; graph captures on "
            f"the serving path {run['path_captures']}; covering steps "
            f"{run['covering']}; graphs (launches captured, replays) "
            f"{run['graphs']}; launches {launches} ({card})")
        require(run["prefills"] == 8, f"{run['prefills']} prefills, want 8")
        require(launches["flash_attention_d192"] == L * 8,
                f"flash_attention_d192 launched {launches} for 8 prefills "
                f"of {L} layers")
        require(run["peak_gib"] < 80, f"peak memory {run['peak_gib']:.2f} "
                "GiB")
        require(len(run["streams"]) == 8 and all(
            len(t) == DEEPSEEK_NEW and all(0 <= v < cfg.vocab_size for v in t)
            for t in run["streams"]), "deepseek streams incomplete")
    graph, eager = runs
    require(graph["path_captures"] == 0,
            f"{graph['path_captures']} captures on the serving path")
    require(bool(graph["graphs"]) and not eager["graphs"],
            "the graph run replayed no graph, or the eager run did")
    replays = sum(r for _, r in graph["graphs"])
    require(replays == graph["decode_steps"],
            f"{replays} graph replays for {graph['decode_steps']} steps")
    require(graph["streams"] == eager["streams"],
            "deepseek graph and eager streams differ")
    log("serving deepseek-v2-lite-16b: graph and eager streams equal, token "
        "for token")
    deepseek_step_breakdown(torch, model, params, scfg)
    torch.cuda.empty_cache()

    def make(first_step):
        def build():
            engine = make_engine(torch, DecodeEngine, model, params, scfg,
                                 True)[0]
            if first_step:
                for p in prompts:
                    engine.submit(p, max_new_tokens=DEEPSEEK_NEW)
                engine.step()
                torch.cuda.synchronize()
            return engine
        return build

    def rest(engine):
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()

    flash = graph["launches"]["flash_attention_d192"]
    profile_serving(torch, make(False),
                    lambda e: serve(torch, e, prompts, DEEPSEEK_NEW),
                    "deepseek-v2-lite-16b graphs", ("flash_attention",),
                    graph["wall"], flash, "flash_attention", None)
    profile_serving(torch, make(True), rest,
                    "deepseek-v2-lite-16b graphs, decode steps",
                    ("flash_attention",), graph["decode_wall"], flash,
                    "flash_attention", None,
                    per_steps=graph["decode_steps"] - 1)
    n_moe = len(params["decoder"]["layers"])
    moe_reference_check(torch, (model, params, True), (model, params, False),
                        tol=LOGIT_REL_TOL, n_moe=n_moe,
                        label="reference check deepseek-v2-lite-16b bf16")
    # the bf16 model's own rounding floor: both bf16 paths on fixed tokens,
    # then the same weights in fp32 (converted in place: 62.8 GB), whose
    # plain path they are measured from
    tokens = torch.randint(1, cfg.vocab_size, (1, 106), device="cuda",
                           dtype=torch.int32,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(5))
    bf16 = {kern: forced_logits(model, params, kern, tokens)
            for kern in (True, False)}
    to_fp32_in_place(params)
    torch.cuda.empty_cache()
    model = build_model(dataclasses.replace(cfg, dtype="float32"), "cuda")
    moe_reference_check(torch, (model, params, True), (model, params, False),
                        tol=FP32_LOGIT_REL_TOL, n_moe=n_moe,
                        label="reference check deepseek-v2-lite-16b fp32")
    fp32 = forced_logits(model, params, False, tokens)
    dist = {kern: [rel_err(a, b) for a, b in zip(bf16[kern], fp32)]
            for kern in (True, False)}
    log("deepseek-v2-lite-16b bf16 rounding floor (fixed tokens, 6 "
        "positions; distance from the fp32 plain path, relative to its "
        "largest |logit|): kernel bf16 "
        + ", ".join(f"{e:.3e}" for e in dist[True]) + "; plain bf16 "
        + ", ".join(f"{e:.3e}" for e in dist[False])
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (logged, not failed)")
    del params, model, bf16, fp32
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"flash_attention_d192": flash}


# ---------------------------------------------------------------------------
# the last serving families: granite-34b (multi-query) and hymba-1.5b
# (attention beside Mamba), full width, through DecodeEngine
# ---------------------------------------------------------------------------

FAMILY_SERVE = dict(max_slots=8, max_len=2048, eos_id=-1, use_kernels=True)
FAMILY_NEW = 32
GRANITE_KERNELS = ("ragged_decode", "flash_attention")
HYMBA_KERNELS = ("ragged_decode", "flash_attention", "mamba_step",
                 "mamba_scan")
# granite's fp32 leg: the published widths cut to this many of 88 layers
# (88 in fp32 would take 136 GB)
GRANITE_FP32_LAYERS = 16
# hymba's prompts past its 1024-token window, beside six of phase 3's
HYMBA_LONG = (1500, 1200)


def family_serving(torch, model, params, prompts, kernels, per_step,
                   per_prefill):
    """A model's prompts through ``DecodeEngine`` (``FAMILY_SERVE``, 32 new
    tokens), after a warm-up engine, on fresh engines in turns: decode
    steps as CUDA graphs, then eager.  Logs each run's prefill ms, decode
    p50, tokens/s, peak memory, captures and launches; requires 8 prefills,
    0 captures on the serving path with graphs, one replay per decode step,
    every kernel of ``per_step`` launched once per layer and decode step
    and of ``per_prefill`` once per layer and prefill, peak memory under
    80 GiB, and the two runs' streams equal.  Returns the graph run."""
    from repro_torch.workloads import DecodeEngine, ServeConfig
    cfg = model.cfg
    name = cfg.name
    scfg = ServeConfig(**FAMILY_SERVE)
    warm = DecodeEngine(model, params, scfg)
    for p in prompts:
        warm.submit(p, max_new_tokens=2)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    runs = [serving_run(torch, DecodeEngine, model, params, scfg, prompts,
                        FAMILY_NEW, kernels, graphs)
            for graphs in (True, False)]
    card = card_line()
    L = cfg.num_layers
    for run in runs:
        launches = run["launches"]
        mean, lo, hi = run["prefill"]
        steps = run["decode_steps"]
        log(f"serving {name} ({run['engine']}, max_len {scfg.max_len}, "
            f"{run['label']}): prompts {[len(p) for p in prompts]}, "
            f"{FAMILY_NEW} new tokens each; prefill ms per request mean "
            f"{mean:.2f} (min {lo:.2f}, max {hi:.2f}); decode ms per step "
            f"p50 {run['p50']:.3f}; {run['tokens']} tokens in "
            f"{run['wall']:.3f} s = {run['tokens_s']:.1f} tokens/s; peak "
            f"memory {run['peak_gib']:.2f} GiB; warm_compile built "
            f"{run['warm'][0]} in {run['warm'][1]:.3f} s; graph captures on "
            f"the serving path {run['path_captures']}; covering steps "
            f"{run['covering']}; graphs (launches captured, replays) "
            f"{run['graphs']}; {steps} decode steps, launches {launches} "
            f"({card})")
        require(run["prefills"] == 8, f"{run['prefills']} prefills, want 8")
        for kern in per_step:
            require(launches[kern] == L * steps > 0,
                    f"{name}: {kern} launched {launches[kern]} for {steps} "
                    f"decode steps of {L} layers")
        for kern in per_prefill:
            require(launches[kern] == L * 8,
                    f"{name}: {kern} launched {launches[kern]} for 8 "
                    f"prefills of {L} layers")
        require(run["peak_gib"] < 80, f"{name}: peak memory "
                f"{run['peak_gib']:.2f} GiB")
        require(len(run["streams"]) == 8 and all(
            len(t) == FAMILY_NEW and all(0 <= v < cfg.vocab_size for v in t)
            for t in run["streams"]), f"{name} streams incomplete")
    graph, eager = runs
    require(graph["path_captures"] == 0,
            f"{graph['path_captures']} captures on the serving path")
    require(bool(graph["graphs"]) and not eager["graphs"],
            "the graph run replayed no graph, or the eager run did")
    replays = sum(r for _, r in graph["graphs"])
    require(replays == graph["decode_steps"],
            f"{replays} graph replays for {graph['decode_steps']} steps")
    require(graph["streams"] == eager["streams"],
            f"{name} graph and eager streams differ")
    log(f"serving {name}: graph and eager streams equal, token for token")

    # the decode steps alone under the profiler (after step 0, which
    # admits and prefills every request): device time per step by kind
    def make():
        engine = make_engine(torch, DecodeEngine, model, params, scfg,
                             True)[0]
        for p in prompts:
            engine.submit(p, max_new_tokens=FAMILY_NEW)
        engine.step()
        torch.cuda.synchronize()
        return engine

    def rest(engine):
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()

    profile_serving(torch, make, rest, f"{name} graphs, decode steps",
                    kernels, graph["decode_wall"],
                    graph["launches"][per_step[0]], per_step[0], None,
                    per_steps=graph["decode_steps"] - 1)
    return graph


def step_vs_bound(torch, model, params, state_bytes: int = 0):
    """One decode step of 8 live slots at 900 rows (a filled engine) as a
    graph at its exact bound (928), timed beside its bound: every weight
    read once (the embedding's 8 rows aside), the live KV rows read, and
    ``state_bytes`` of recurrent state read and written."""
    from repro_torch.workloads import DecodeEngine, ServeConfig
    cfg = model.cfg
    engine, _ = filled_engine(torch, DecodeEngine, model, params,
                              ServeConfig(**FAMILY_SERVE), 900,
                              FAMILY_SERVE["max_len"])
    pool = engine._pool
    pool.inputs[2].fill_(1)                     # every slot live
    step = engine._build_decode(pool, (928,))
    torch.cuda.synchronize()            # the capture ran on engine streams
    step_ms = time_ms(torch, step, reps=10)
    wbytes = param_bytes(params) - param_bytes(params["embed"])
    es = params["embed"].element_size()
    kbytes = (8 * 900 * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * es
              * cfg.num_layers)
    b_ms, _ = bound(wbytes + kbytes + state_bytes, 0.0, "bfloat16")
    log(f"{cfg.name} decode step (graph, 8 slots at 900 rows, bound 928): "
        f"{step_ms:.3f} ms, bound {b_ms:.3f} ms (bytes: {wbytes / 1e9:.2f} "
        f"GB of weights, {kbytes / 1e9:.3f} GB of KV, "
        f"{state_bytes / 1e9:.3f} GB of state at 3.35 TB/s; "
        f"{step_ms / b_ms:.2f}x) ({card_line()})")
    del engine, step
    return step_ms, b_ms


def run_granite_phase(torch):
    """Full-width granite-34b (88 layers, d_model 6144, 48 query heads on
    one KV head, head dim 128, a GELU FFN of 24576 without GLU; random bf16
    weights from seed 0, 67.9 GB) through ``DecodeEngine`` with the
    kernels on: phase 3's 8 prompts, 32 new tokens, 8 slots, ``max_len``
    2048, decode steps as graphs then eager (``family_serving``): ragged
    decode in 6 head groups of 8 launched 88 times per step, flash 88 times
    per prefill.  Then a decode step beside its weight bound, and the
    kernel path's logits against the plain path's in bf16 at full depth
    (5e-2, argmax partings only at counted near-ties).  The bf16 weights
    freed, the fp32 leg runs at the published widths cut to
    ``GRANITE_FP32_LAYERS`` layers (1e-3).  Frees its weights; returns the
    graph run's ragged decode launches."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.workloads import DecodeEngine, ServeConfig
    cfg = get_config("granite-34b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"granite-34b: {cfg.param_count() / 1e9:.2f} B params "
        f"({cfg.num_layers} layers, {cfg.num_heads} query heads on "
        f"{cfg.num_kv_heads} KV head), random bf16 weights "
        f"({param_bytes(params) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    engine = DecodeEngine(model, params, ServeConfig(**FAMILY_SERVE))
    per_tok = engine._per_token_elems
    del engine
    log(f"granite-34b admission: {per_tok} KV elements per token over "
        f"{cfg.num_layers} layers (2 x {cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim} per layer)")
    require(per_tok == 22528, f"per-token cache elements {per_tok}, want "
            "22528")
    graph = family_serving(torch, model, params, serving_prompts(cfg),
                           GRANITE_KERNELS, ("ragged_decode",),
                           ("flash_attention",))
    step_vs_bound(torch, model, params)
    torch.cuda.empty_cache()
    run_reference_check(torch, (model, params, True), (model, params, False),
                        tol=LOGIT_REL_TOL,
                        label="reference check granite-34b bf16")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=GRANITE_FP32_LAYERS,
                              dtype="float32")
    model = build_model(cut, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    log(f"granite-34b fp32 leg: published widths cut to "
        f"{GRANITE_FP32_LAYERS} of {cfg.num_layers} layers "
        f"({param_bytes(params) / 1e9:.2f} GB in fp32; all 88 would take "
        f"{cfg.param_count() * 4 / 1e9:.0f} GB)")
    run_reference_check(torch, (model, params, True), (model, params, False),
                        tol=FP32_LOGIT_REL_TOL,
                        label=f"reference check granite-34b fp32 "
                              f"({GRANITE_FP32_LAYERS} layers)")
    del params, model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"ragged_decode_g48": graph["launches"]["ragged_decode"]}


def hymba_prompts(cfg):
    """Two prompts past hymba's 1024-token window (``HYMBA_LONG``, seed 4)
    and six of phase 3's."""
    import numpy as np
    rng = np.random.default_rng(4)
    long = [rng.integers(1, cfg.vocab_size, size=n) for n in HYMBA_LONG]
    return long + serving_prompts(cfg)[:6]


def run_hymba_phase(torch):
    """Full-width hymba-1.5b (32 layers, d_model 1600; in every layer GQA
    attention, 25 heads on 5, head dim 64, sliding window 1024 but the
    global layers 0, 15 and 31, beside a Mamba block of d_in 3200, N 16;
    random bf16 weights from seed 0) through ``DecodeEngine`` with the
    kernels on: 8 prompts, two of them past the window (``hymba_prompts``),
    32 new tokens, 8 slots, ``max_len`` 2048, decode steps as graphs then
    eager (``family_serving``): per decode step 32 launches each of ragged
    decode and the Mamba step, per prefill 32 each of flash and the scan.
    Then a decode step beside its bound, and for each weight seed of
    ``SSM_CHECK_SEEDS`` the kernel path against the plain path from a
    1100-token prompt (past the window) at full depth: fp32 within 1e-3,
    bf16 within 1 + ``SSM_FLOOR_MARGIN`` of the model's own bf16 rounding
    floor, as falcon-mamba-7b is held.  Returns the graph run's
    launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    from repro_torch.models.model import build_model
    cfg = get_config("hymba-1.5b")
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    d_in, R, N, _ = S.dims(cfg)
    log(f"hymba-1.5b: {cfg.param_count() / 1e9:.2f} B params "
        f"({cfg.num_layers} layers, window {cfg.window_size}, global "
        f"{cfg.global_attn_layers}; Mamba d_in {d_in}, dt_rank {R}, N {N}), "
        f"random bf16 weights ({param_bytes(params) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    prompts = hymba_prompts(cfg)
    require(sum(len(p) > cfg.window_size for p in prompts) >= 2,
            "hymba prompts do not cross the window")
    graph = family_serving(torch, model, params, prompts, HYMBA_KERNELS,
                           ("ragged_decode", "mamba_step"),
                           ("flash_attention", "mamba_scan"))
    # each slot's fp32 state and bf16 conv window, read and written
    d_in, _, N, w = S.dims(cfg)
    state = 2 * 8 * cfg.num_layers * (d_in * N * 4 + (w - 1) * d_in * 2)
    step_vs_bound(torch, model, params, state_bytes=state)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    run_ssm_reference_checks(torch, model, S=1100)
    del model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return graph["launches"]


# ---------------------------------------------------------------------------
# training: the flash backward kernel, minitron-4b, the trainer's loop
# ---------------------------------------------------------------------------

# flash backward cases: (label, B, S, Hq, Hkv, D, causal) - minitron-4b's
# heads at its training batch, granite's multi-query heads, llama-100m's
# head dim 64 (causal, and bidirectional), a length that is no multiple
# of the tile, and deepseek-v2-lite's MLA at its training batch (16 heads,
# K and V expanded to all of them; q/k head dim 192, V padded to it)
BWD_CASES = (("minitron", 4, 1024, 24, 8, 128, True),
             ("granite MQA", 1, 1024, 48, 1, 128, True),
             ("llama-100m", 8, 256, 10, 5, 64, True),
             ("llama-100m bidirectional", 8, 256, 10, 5, 64, False),
             ("S1000", 1, 1000, 24, 8, 128, True),
             ("MLA", 4, 1024, 16, 16, 192, True))
# training checks, kernel path vs plain path from the same params and
# batch: (loss relative, each gradient leaf's relative norm).  bf16: the
# two round p, ds and every activation at other points over 32 layers;
# fp32: summation order only
TRAIN_TOL = {"bfloat16": (2e-2, 5e-2), "float32": (1e-4, 1e-3)}
TRAIN_B, TRAIN_S = 4, 1024
TRAIN_STEPS = 8
TRAINER_ARGS = ["--arch", "llama-100m", "--steps", "30", "--seq-len", "256",
                "--global-batch", "8", "--device", "cuda"]
TRAINER_PREEMPT_AT = 10


def attended_pairs(B: int, S: int, H: int, causal: bool) -> int:
    return B * H * (S * (S + 1) // 2 if causal else S * S)


def run_flash_bwd_phase(torch, gen, reps: int):
    """The forward kernel's lse and the backward kernel against their
    plain versions on the same inputs at ``BWD_CASES`` (bf16 and fp32: the
    plain backward gets the kernel's out and lse), then timed at each
    case's shape in bf16: the backward beside its bound (10 D flops per
    attended pair at the bf16 peak), the plain backward and SDPA's forward
    plus backward; the forward with lse beside its bound and SDPA's
    forward.  Returns the kernels' entries: up to head dim 128 minitron's
    times (the backward's also granite's multi-query time, bound and SDPA
    time as ``mqa_ms``, ``mqa_bound_ms`` and ``mqa_library_ms``, and both
    shapes' fp32 times as ``fp32_ms`` and ``mqa_fp32_ms``), and at head
    dim 192 (the ``_d192`` entries) MLA's, its fp32 time as ``fp32_ms``."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    worst = dict.fromkeys(("lse", "bwd", "lse_d192", "bwd_d192"), 0.0)
    times = {}
    for label, B, S, Hq, Hkv, D, causal in BWD_CASES:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, dout = (torch.randn((B, S, Hq, D), generator=gen,
                                   device="cuda").to(dt) for _ in range(2))
            k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
            out_r, lse_r = flash_attention_lse_ref(q, k, v, causal=causal)
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=causal)
            want = flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           causal=causal)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            errs = {"out": (out.float() - out_r.float()).abs().max().item(),
                    "lse": (lse - lse_r).abs().max().item()}
            errs.update({n: (a.float() - b.float()).abs().max().item()
                         for n, a, b in zip(("dq", "dk", "dv"), got, want)})
            ok = (agree(out, out_r, tol) and errs["lse"] <= tol
                  and all(agree(a, b, tol) for a, b in zip(got, want)))
            log(f"flash backward {label} (B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, "
                f"D {D}, causal {causal}) {dtype}: max_abs_err "
                + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f"; tol {tol:.0e} abs + rel (lse abs)")
            require(ok and all(math.isfinite(e) for e in errs.values()),
                    f"flash backward {label} {dtype} disagrees with its "
                    f"plain version")
            if dtype == "bfloat16":
                sfx = "_d192" if D > 128 else ""
                worst["lse" + sfx] = max(worst["lse" + sfx], errs["out"],
                                         errs["lse"])
                worst["bwd" + sfx] = max(worst["bwd" + sfx], errs["dq"],
                                         errs["dk"], errs["dv"])
                times[label] = time_flash_training(
                    torch, fa, (q, k, v, out, dout, lse), causal, reps,
                    flash_attention_bwd_ref, flash_attention_lse_ref)
            elif label in ("minitron", "granite MQA", "MLA"):
                # fp32 stays on the CUDA cores (TF32 would change its sums)
                ms = time_ms(torch, lambda: fa.flash_attention_bwd(
                    q, k, v, out, dout, lse, causal=causal), 3)
                pairs = attended_pairs(B, S, Hq, causal)
                times[label]["bwd_fp32"] = ms
                log(f"flash backward {label} fp32 (CUDA cores): {ms:.4f} ms, "
                    f"{10 * D * pairs / ms / 1e9:.1f} TFLOP/s at 10 D per "
                    f"pair ({card_line()})")
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    t, mqa, mla = times["minitron"], times["granite MQA"], times["MLA"]
    log(f"flash backward granite MQA: {mqa['bwd']:.4f} ms against its bound "
        f"{mqa['bwd_bound'][0]:.4f} ms and SDPA forward + backward "
        f"{mqa['sdpa_fwd_bwd']:.4f} ms ({card_line()})")
    return {
        "flash_attention_lse_d192": dict(
            name="flash_attention_lse_d192", route="cuda",
            source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:85",
            max_abs_err=worst["lse_d192"], ms=mla["fwd"],
            plain_ms=mla["fwd_plain"], bound_ms=mla["fwd_bound"][0],
            bound_by=mla["fwd_bound"][1], library_ms=mla["sdpa_fwd"]),
        "flash_attention_bwd_d192": dict(
            name="flash_attention_bwd_d192", route="cuda",
            source=src + "flash_attention_bwd.cu",
            replaces="src/repro/models/layers.py:222",
            max_abs_err=worst["bwd_d192"], ms=mla["bwd"],
            plain_ms=mla["bwd_plain"], bound_ms=mla["bwd_bound"][0],
            bound_by=mla["bwd_bound"][1], library_ms=mla["sdpa_fwd_bwd"],
            fp32_ms=mla["bwd_fp32"]),
        "flash_attention_lse": dict(
            name="flash_attention_lse", route="cuda",
            source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:85",
            max_abs_err=worst["lse"], ms=t["fwd"], plain_ms=t["fwd_plain"],
            bound_ms=t["fwd_bound"][0], bound_by=t["fwd_bound"][1],
            library_ms=t["sdpa_fwd"]),
        "flash_attention_bwd": dict(
            name="flash_attention_bwd", route="cuda",
            source=src + "flash_attention_bwd.cu",
            replaces="src/repro/models/layers.py:222",
            max_abs_err=worst["bwd"], ms=t["bwd"], plain_ms=t["bwd_plain"],
            bound_ms=t["bwd_bound"][0], bound_by=t["bwd_bound"][1],
            library_ms=t["sdpa_fwd_bwd"], mqa_ms=mqa["bwd"],
            mqa_bound_ms=mqa["bwd_bound"][0],
            mqa_library_ms=mqa["sdpa_fwd_bwd"], fp32_ms=t["bwd_fp32"],
            mqa_fp32_ms=mqa["bwd_fp32"])}


def time_flash_training(torch, fa, tensors, causal, reps, bwd_ref, lse_ref):
    """Device times (ms) of one case: the forward with lse and the backward
    kernels, their plain versions, SDPA's forward and its forward plus
    backward (GQA by ``enable_gqa``), and the bounds."""
    F = torch.nn.functional
    q, k, v, out, dout, lse = tensors
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    es = q.element_size()
    pairs = attended_pairs(B, S, Hq, causal)
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * es
    r = dict(
        fwd=time_ms(torch, lambda: fa.flash_attention_lse(
            q, k, v, causal=causal), reps),
        fwd_plain=time_ms(torch, lambda: lse_ref(q, k, v, causal=causal),
                          max(reps // 4, 3)),
        bwd=time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, dout, lse, causal=causal), reps),
        bwd_plain=time_ms(torch, lambda: bwd_ref(
            q, k, v, out, dout, lse, causal=causal), max(reps // 4, 3)),
        fwd_bound=bound(qkv_bytes + out.numel() * es + lse.numel() * 4,
                        4 * D * pairs, "bfloat16"),
        bwd_bound=bound(2 * qkv_bytes + 2 * out.numel() * es
                        + lse.numel() * 4, 10 * D * pairs, "bfloat16"))
    qh, kh, vh, dh = (t.transpose(1, 2).detach().clone().requires_grad_(
        t is not dout) for t in (q, k, v, dout))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                           enable_gqa=True)

    def sdpa_fwd_bwd():
        for t in (qh, kh, vh):
            t.grad = None
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                       enable_gqa=True).backward(dh)

    r["sdpa_fwd"] = time_ms(torch, sdpa_fwd, reps)
    r["sdpa_fwd_bwd"] = time_ms(torch, sdpa_fwd_bwd, reps)
    kinds = cuda_launches(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, dout, lse, causal=causal))
    # the backward's grids: dK/dV blocks split over the group's heads,
    # the fold's blocks where it splits, dQ blocks
    n_split = fa.bwd_plan(B, S, Hq, Hkv, torch.cuda.get_device_properties(
        0).multi_processor_count, D)
    tiles = -(-S // 64)
    fold = -(-2 * B * S * Hkv * D // 4 // 256) if n_split > 1 else 0
    log(f"flash training timing (B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, "
        f"causal {causal}, bf16, {pairs} attended pairs): backward "
        f"{r['bwd']:.4f} ms (bound {r['bwd_bound'][0]:.4f} ms, "
        f"{r['bwd_bound'][1]}; {10 * D * pairs / r['bwd'] / 1e9:.1f} "
        f"TFLOP/s at 10 D per pair, {14 * D * pairs / r['bwd'] / 1e9:.1f} "
        f"at the 14 D it computes; n_split {n_split}, blocks dK/dV "
        f"{B * Hkv * tiles * n_split}, fold {fold}, dQ {B * Hq * tiles}), "
        f"plain {r['bwd_plain']:.4f} ms; forward "
        f"with lse {r['fwd']:.4f} ms (bound {r['fwd_bound'][0]:.4f} ms), "
        f"plain {r['fwd_plain']:.4f} ms; ours forward + backward "
        f"{r['fwd'] + r['bwd']:.4f} ms against sdpa {r['sdpa_fwd_bwd']:.4f} "
        f"ms (sdpa forward {r['sdpa_fwd']:.4f} ms); CUDA launches per "
        f"backward call {sum(kinds.values())} {kinds} ({card_line()})")
    return r


# ---------------------------------------------------------------------------
# SSM and hybrid training: the scan's training kernels, the windowed flash
# ---------------------------------------------------------------------------

# the scan's training kernels at each model's training layer: (label, B,
# S, d_in, N)
SCAN_TRAIN_CASES = (("falcon-mamba-7b", 4, 1024, 8192, 16),
                    ("hymba-1.5b", 2, 2048, 3200, 16))
# hymba-1.5b's attention at its training shape: B, S, Hq, Hkv, D, window
HYMBA_FLASH = (2, 2048, 25, 5, 64, 1024)


def scan_train_work(B: int, S: int, D: int, N: int, es: int):
    """(forward bytes, backward bytes, exponentials, forward flops,
    backward flops) of the scan's training pair.  The forward reads x, dt,
    B, C, A_log and D and writes y, the last state and the boundary
    states; the backward reads x, dt, B, C, A_log, D, the boundaries and
    gy and writes dx, ddt, dB, dC, dA and dD.  One exponential per
    state-step (the backward needs a_t once; the kernel takes it twice,
    once to recompute the state and once to carry g); six flops per
    state-step and three per output forward, 18 and 7 backward."""
    n = B * S * D
    bc = 2 * B * S * N * es
    par = 4 * D * (N + 1)
    bnd = 4 * -(-S // 32) * B * D * N
    fwd = n * es + n * 4 + bc + par + n * 4 + 4 * B * D * N + bnd
    bwd = n * es + n * 4 + bc + par + bnd + n * 4 + n * es + n * 4 + bc + par
    return fwd, bwd, n * N, 6 * n * N + 3 * n, 18 * n * N + 7 * n


def close_scaled(got, want, tol: float) -> bool:
    """max |got - want| within tol of want's largest magnitude, got finite:
    sums over thousands of channels or steps cancel, so an element's own
    size is no scale for its error."""
    g, w = got.float(), want.float()
    scale = max(w.abs().max().item(), 1e-6)
    return bool((g - w).abs().max().item() <= tol * scale
                and g.isfinite().all().item())


def run_scan_train_phase(torch, reps: int = 10):
    """The scan's training forward (boundary states on) and its backward
    kernel against the plain pair at ``SCAN_TRAIN_CASES``, bf16 and fp32
    (the forward's y must equal the serving instance's bitwise), then both
    timed in bf16 beside their bounds and the plain pair.  Returns the two
    kernels' entries, falcon's layer as the main numbers and hymba's as
    ``hymba_*``."""
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import (selective_scan_bwd_ref,
                                                    selective_scan_fwd_ref,
                                                    softplus)
    gen = torch.Generator(device="cuda").manual_seed(12)
    card = card_line()
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    names = ("dx", "ddt", "db", "dc", "dA", "dD")
    for label, B, S_len, D, N in SCAN_TRAIN_CASES:
        a_log, d_vec = scan_params(torch, D, N)
        for dtype in ("bfloat16", "float32"):
            dt_ = getattr(torch, dtype)
            x = torch.randn((B, S_len, D), generator=gen,
                            device="cuda").to(dt_)
            delta = softplus(torch.randn((B, S_len, D), generator=gen,
                                         device="cuda") - 4.0)
            R = 256
            dbc = torch.randn((B, S_len, R + 2 * N), generator=gen,
                              device="cuda").to(dt_)
            bm, cm = dbc[..., R:R + N], dbc[..., R + N:]
            gy = torch.randn((B, S_len, D), generator=gen, device="cuda")
            ins = (x, delta, bm, cm, a_log, d_vec)
            y, h, bnd = ms.mamba_scan(*ins, bounds=True)
            y_s, h_s = ms.mamba_scan(*ins)
            y_r, bnd_r = selective_scan_fwd_ref(*ins)
            got = ms.mamba_scan_bwd(*ins, bnd, gy)
            want = selective_scan_bwd_ref(*ins, bnd, gy)
            torch.cuda.synchronize()
            require(torch.equal(y, y_s) and torch.equal(h, h_s),
                    f"scan training forward {label} {dtype}: y differs from "
                    f"the serving instance's")
            fwd_err = max((y - y_r).abs().max().item(),
                          (bnd - bnd_r).abs().max().item())
            errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)]
            tols = [TOL[dtype] if g.dtype == torch.bfloat16 else 1e-4
                    for g in got]
            ok = (agree(y, y_r, 1e-4) and agree(bnd, bnd_r, 1e-4)
                  and all(close_scaled(g, w, t)
                          for g, w, t in zip(got, want, tols)))
            log(f"scan training {label} (B {B}, S {S_len}, d_in {D}, N {N}) "
                f"{dtype}: forward max_abs_err {fwd_err:.3e} (y bitwise the "
                f"serving instance's); backward max_abs_err "
                + " ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
                + "; tol 1e-4 (fp32 outputs) or the dtype's of the tensor's "
                  "largest magnitude")
            require(ok, f"scan training {label} {dtype} disagrees with the "
                    f"plain pair")
            if dtype == "bfloat16":
                worst["fwd"] = max(worst["fwd"], fwd_err)
                worst["bwd"] = max(worst["bwd"], *errs)
                fb, bb, exps, ff, bf = scan_train_work(B, S_len, D, N, 2)
                t = dict(
                    fwd=time_ms(torch, lambda: ms.mamba_scan(
                        *ins, bounds=True), reps),
                    fwd_plain=time_ms(torch, lambda: selective_scan_fwd_ref(
                        *ins), 3),
                    bwd=time_ms(torch, lambda: ms.mamba_scan_bwd(
                        *ins, bnd, gy), reps),
                    bwd_plain=time_ms(torch, lambda: selective_scan_bwd_ref(
                        *ins, bnd, gy), 3),
                    serve=time_ms(torch, lambda: ms.mamba_scan(*ins), reps),
                    fwd_bound=bound(fb, ff, "float32", exps=exps),
                    bwd_bound=bound(bb, bf, "float32", exps=exps))
                blocks = B * -(-D // ms.bwd_channels(N))
                log(f"scan training timing {label} (B {B}, S {S_len}, d_in "
                    f"{D}, N {N}, bf16): forward with boundary states "
                    f"{t['fwd']:.4f} ms (serving instance {t['serve']:.4f} "
                    f"ms; bound {t['fwd_bound'][0]:.4f} ms, "
                    f"{t['fwd_bound'][1]}, {fb / 1e6:.1f} MB), plain "
                    f"{t['fwd_plain']:.4f} ms; backward {t['bwd']:.4f} ms "
                    f"(bound {t['bwd_bound'][0]:.4f} ms, {t['bwd_bound'][1]}: "
                    f"{bb / 1e6:.1f} MB = {bb / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                    f"{exps / 1e6:.0f} M exponentials = "
                    f"{exps / (SFU_EXP_PER_S + FMA_EXP_PER_S) * 1e3:.4f} ms, "
                    f"{bf / 1e9:.2f} GFLOP fp32 = {bf / F32_FLOPS * 1e3:.4f} "
                    f"ms; {bb / t['bwd'] / 1e9:.3f} TB/s; {blocks} blocks of "
                    f"{ms._BWD_THREADS} threads, {ms.bwd_channels(N)} "
                    f"channels each, and a fold launch), plain "
                    f"{t['bwd_plain']:.4f} ms; library none: no PyTorch call "
                    f"computes the selective scan or its gradient ({card})")
                times[label] = t
            del x, delta, dbc, gy, got, want, bnd, bnd_r, y, y_s, y_r
        torch.cuda.empty_cache()
    log_scan_build()
    src = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
    f, h = times["falcon-mamba-7b"], times["hymba-1.5b"]
    return {
        "mamba_scan_train": dict(
            name="mamba_scan_train", route="cuda", source=src,
            replaces="src/repro/kernels/mamba_scan/kernel.py:165",
            max_abs_err=worst["fwd"], ms=f["fwd"], plain_ms=f["fwd_plain"],
            bound_ms=f["fwd_bound"][0], bound_by=f["fwd_bound"][1],
            library_ms=None, hymba_ms=h["fwd"],
            hymba_bound_ms=h["fwd_bound"][0]),
        "mamba_scan_bwd": dict(
            name="mamba_scan_bwd", route="cuda", source=src,
            replaces="src/repro/models/ssm.py:277",
            max_abs_err=worst["bwd"], ms=f["bwd"], plain_ms=f["bwd_plain"],
            bound_ms=f["bwd_bound"][0], bound_by=f["bwd_bound"][1],
            library_ms=None, hymba_ms=h["bwd"],
            hymba_bound_ms=h["bwd_bound"][0])}


def window_pairs(B: int, S: int, H: int, window: int) -> int:
    """Attended (query, key) pairs of causal attention under a sliding
    window: query i sees min(i + 1, window) keys."""
    W = min(window, S)
    return B * H * (W * (W + 1) // 2 + (S - W) * W)


def run_window_flash_phase(torch, reps: int = 10):
    """The windowed flash forward with lse and backward against their plain
    versions at hymba-1.5b's training shape (``HYMBA_FLASH``), bf16 and
    fp32, on a sliding and on a global layer, then timed in bf16 beside
    the bound over the window's attended pairs, the plain versions, SDPA's
    forward and its forward plus backward under the same boolean mask,
    and the same backward on a global layer (causal, no window).  Returns
    the two windowed kernels' entries."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    F = torch.nn.functional
    B, S_len, Hq, Hkv, D, W = HYMBA_FLASH
    gen = torch.Generator(device="cuda").manual_seed(13)
    card = card_line()
    worst = {"lse": 0.0, "bwd": 0.0}
    for dtype in ("bfloat16", "float32"):
        dt_ = getattr(torch, dtype)
        q, dout = (torch.randn((B, S_len, Hq, D), generator=gen,
                               device="cuda").to(dt_) for _ in range(2))
        k, v = (torch.randn((B, S_len, Hkv, D), generator=gen,
                            device="cuda").to(dt_) for _ in range(2))
        for glob in (False, True):
            kw = dict(causal=True, window=W, is_global=glob)
            out, lse = fa.flash_attention_lse(q, k, v, **kw)
            out_r, lse_r = flash_attention_lse_ref(q, k, v, **kw)
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            want = flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)
            torch.cuda.synchronize()
            tol = TOL[dtype]
            errs = {"out": (out.float() - out_r.float()).abs().max().item(),
                    "lse": (lse - lse_r).abs().max().item()}
            errs.update({n: (a.float() - b.float()).abs().max().item()
                         for n, a, b in zip(("dq", "dk", "dv"), got, want)})
            ok = (agree(out, out_r, tol) and errs["lse"] <= tol
                  and all(agree(a, b, tol) for a, b in zip(got, want)))
            log(f"flash window {W} (B {B}, S {S_len}, Hq {Hq}, Hkv {Hkv}, D "
                f"{D}, global {glob}) {dtype}: max_abs_err "
                + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f"; tol {tol:.0e} abs + rel (lse abs)")
            require(ok, f"windowed flash {dtype} global {glob} disagrees "
                    f"with its plain versions")
            if dtype == "bfloat16" and not glob:
                worst["lse"] = max(worst["lse"], errs["out"], errs["lse"])
                worst["bwd"] = max(worst["bwd"], errs["dq"], errs["dk"],
                                   errs["dv"])
        if dtype == "bfloat16":
            bf16 = (q, k, v, dout)
    q, k, v, dout = bf16
    kw = dict(causal=True, window=W, is_global=False)
    out, lse = fa.flash_attention_lse(q, k, v, **kw)
    pairs = window_pairs(B, S_len, Hq, W)
    full = attended_pairs(B, S_len, Hq, True)
    es = q.element_size()
    qkv = (q.numel() + k.numel() + v.numel()) * es
    t = dict(
        fwd=time_ms(torch, lambda: fa.flash_attention_lse(q, k, v, **kw),
                    reps),
        fwd_plain=time_ms(torch, lambda: flash_attention_lse_ref(
            q, k, v, **kw), 3),
        bwd=time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, dout, lse, **kw), reps),
        bwd_plain=time_ms(torch, lambda: flash_attention_bwd_ref(
            q, k, v, out, dout, lse, **kw), 3),
        fwd_bound=bound(qkv + out.numel() * es + lse.numel() * 4,
                        4 * D * pairs, "bfloat16"),
        bwd_bound=bound(2 * qkv + 2 * out.numel() * es + lse.numel() * 4,
                        10 * D * pairs, "bfloat16"))
    out_g, lse_g = fa.flash_attention_lse(q, k, v, causal=True)
    t["bwd_global"] = time_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out_g, dout, lse_g, causal=True), reps)
    t["bwd_global_bound"] = bound(
        2 * qkv + 2 * out.numel() * es + lse.numel() * 4, 10 * D * full,
        "bfloat16")
    qpos = torch.arange(S_len, device="cuda")
    mask = ((qpos[None, :] <= qpos[:, None])
            & (qpos[None, :] > qpos[:, None] - W))
    qh, kh, vh, dh = (x.transpose(1, 2).detach().clone().requires_grad_(
        x is not dout) for x in (q, k, v, dout))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                           enable_gqa=True)

    def sdpa_fwd_bwd():
        for x in (qh, kh, vh):
            x.grad = None
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                       enable_gqa=True).backward(dh)

    t["sdpa_fwd"] = time_ms(torch, sdpa_fwd, reps)
    t["sdpa_fwd_bwd"] = time_ms(torch, sdpa_fwd_bwd, reps)
    kinds = cuda_launches(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, dout, lse, **kw))
    log(f"flash window timing (hymba-1.5b training: B {B}, S {S_len}, "
        f"Hq {Hq}, Hkv {Hkv}, D {D}, window {W}, bf16; {pairs} attended "
        f"pairs in the window of {full} causal): backward {t['bwd']:.4f} "
        f"ms (bound {t['bwd_bound'][0]:.4f} ms, {t['bwd_bound'][1]}; "
        f"{10 * D * pairs / t['bwd'] / 1e9:.1f} TFLOP/s at 10 D per "
        f"pair), plain {t['bwd_plain']:.4f} ms; the same backward on a "
        f"global layer {t['bwd_global']:.4f} ms (bound "
        f"{t['bwd_global_bound'][0]:.4f} ms); forward with lse "
        f"{t['fwd']:.4f} ms (bound {t['fwd_bound'][0]:.4f} ms), plain "
        f"{t['fwd_plain']:.4f} ms; ours forward + backward "
        f"{t['fwd'] + t['bwd']:.4f} ms against SDPA under the same mask "
        f"{t['sdpa_fwd_bwd']:.4f} ms (SDPA forward {t['sdpa_fwd']:.4f} "
        f"ms); n_split {fa.bwd_plan(B, S_len, Hq, Hkv, 132, D)}, CUDA "
        f"launches per backward call {sum(kinds.values())} {kinds} "
        f"({card})")
    del qh, kh, vh, dh, mask
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    torch.cuda.empty_cache()
    return {
        "flash_attention_lse_window": dict(
            name="flash_attention_lse_window", route="cuda",
            source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:85",
            max_abs_err=worst["lse"], ms=t["fwd"], plain_ms=t["fwd_plain"],
            bound_ms=t["fwd_bound"][0], bound_by=t["fwd_bound"][1],
            library_ms=t["sdpa_fwd"]),
        "flash_attention_bwd_window": dict(
            name="flash_attention_bwd_window", route="cuda",
            source=src + "flash_attention_bwd.cu",
            replaces="src/repro/models/layers.py:222",
            max_abs_err=worst["bwd"], ms=t["bwd"], plain_ms=t["bwd_plain"],
            bound_ms=t["bwd_bound"][0], bound_by=t["bwd_bound"][1],
            library_ms=t["sdpa_fwd_bwd"], global_ms=t["bwd_global"],
            global_bound_ms=t["bwd_global_bound"][0])}


def loss_and_grads(torch, model, params, batch, use_kernels: bool):
    """One forward and backward: (loss, [fp32 gradient per leaf])."""
    from repro_torch.optim import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch, use_kernels=use_kernels)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    torch.cuda.synchronize()
    return loss.item(), grads


def grad_distances(g_a, g_b):
    """Each gradient leaf's relative norm |a - b| / |b|."""
    return [((a - b).norm() / b.norm().clamp(min=1e-30)).item()
            for a, b in zip(g_a, g_b)]


def hold_grads(kernel, plain, dtype: str, label: str):
    """The kernel path's (loss, grads) against the plain path's: the loss
    within TRAIN_TOL's first, each gradient leaf's relative norm within
    its second."""
    (loss_k, g_k), (loss_p, g_p) = kernel, plain
    loss_tol, grad_tol = TRAIN_TOL[dtype]
    rel = grad_distances(g_k, g_p)
    worst = max(range(len(rel)), key=rel.__getitem__)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"{label}: loss kernel {loss_k:.6f} plain {loss_p:.6f} (relative "
        f"{loss_rel:.3e}, tol {loss_tol:.0e}); gradient leaves {len(rel)}, "
        f"largest relative norm {rel[worst]:.3e} (leaf {worst}), median "
        f"{sorted(rel)[len(rel) // 2]:.3e}, tol {grad_tol:.0e}")
    require(math.isfinite(loss_k) and loss_rel <= loss_tol
            and max(rel) <= grad_tol,
            f"{label}: kernel path disagrees with the plain path")


def train_path_check(torch, model, params, batch, dtype: str, label: str):
    """Kernel path against plain path from the same params and batch, held
    by ``hold_grads``."""
    kernel = loss_and_grads(torch, model, params, batch, True)
    plain = loss_and_grads(torch, model, params, batch, False)
    hold_grads(kernel, plain, dtype, label)
    return kernel[1], plain[1]


def training_flops(model, params, T: int, B: int, S: int) -> float:
    """Model FLOPs of one remat training step: 8 N T for the weight
    products (6 N T forward and backward, 2 N T the remat forward; N the
    matrices a token passes through: the layers' and the LM head, of an MoE
    layer's routed experts top_k of E, as the model routes, its router and
    shared experts whole), 8 (Dqk + Dv) per attended pair per layer for
    attention (forward, remat forward, backward; 16 D where both are D),
    over the window's pairs on sliding layers and none on attention-free
    ones.  A Mamba block's scan is elementwise and not counted."""
    from repro_torch.optim import tree_leaves
    cfg = model.cfg
    layers = params["decoder"]["prologue"] + params["decoder"]["layers"]

    def matrices(tree, share=1.0):
        return share * sum(p.numel() for p in tree_leaves(tree)
                           if p.ndim >= 2)

    n_mm = 0.0
    for lp in layers:
        for key, sub in lp.items():
            if key == "moe":
                mo = cfg.moe
                n_mm += sum(matrices(t, mo.top_k / mo.num_experts
                                     if k == "experts" else 1.0)
                            for k, t in sub.items())
            else:
                n_mm += matrices(sub)
    n_mm += params["lm_head"].numel() if "lm_head" in params else \
        params["embed"].numel()
    if cfg.mla is not None:
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.resolved_head_dim
    pairs = 0
    for i, lp in enumerate(layers):
        if "attn" not in lp:          # attention-free Mamba
            continue
        sliding = (cfg.attn_type == "sliding"
                   and i not in cfg.global_attn_layers)
        pairs += (window_pairs(B, S, cfg.num_heads, cfg.window_size)
                  if sliding else attended_pairs(B, S, cfg.num_heads, True))
    return 8.0 * n_mm * T + 8.0 * (dqk + dv) * pairs


def run_training_phase(torch):
    """Full-width minitron-4b training on one card (fp32 masters, bf16
    activations, AdamW, remat, B 4 x S 1024 from the port's SyntheticLM):
    (a) kernel vs plain path at 32 layers in bf16, (b) at 4 layers in fp32,
    (c) 8 steps of make_train_step on the kernel path, timed.  Returns the
    kernels' launches over (c)."""
    import dataclasses
    import gc
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import Optimizer, make_optimizer, tree_leaves
    from repro_torch.train import TrainConfig, make_train_step

    card = card_line()
    cfg = get_config("minitron-4b")
    pipe = make_pipeline(cfg, TRAIN_S, TRAIN_B, seed=0)

    def batch_of(step):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in pipe.batch(step).items()}

    # (b) first, at 4 layers in fp32, on the empty card
    cfg4 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model = build_model(cfg4, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg4.param_dtype)
    train_path_check(torch, model, params, batch_of(0), "float32",
                     "training check minitron-4b widths, 4 layers, fp32")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.param_dtype)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    log(f"minitron-4b training: {n / 1e9:.3f} B params as fp32 masters in "
        f"{time.perf_counter() - t0:.2f} s; bf16 activations, AdamW, remat, "
        f"B {TRAIN_B} x S {TRAIN_S}")
    g = train_path_check(torch, model, params, batch_of(0), "bfloat16",
                         f"training check minitron-4b, {cfg.num_layers} "
                         f"layers, bf16")
    del g
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the kernel path's steps, the optimizer timed by CUDA events
    opt = make_optimizer(cfg.optimizer)
    opt_ms = []

    def timed_update(grads, state, params_, lr):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = opt.update(grads, state, params_, lr)
        e.record()
        opt_ms.append((s, e))
        return out

    tc = TrainConfig(steps=TRAIN_STEPS, lr=3e-4, warmup=2)
    step_fn = make_train_step(model, Optimizer(opt.init, timed_update), tc)
    opt_state = opt.init(params)
    batches = [batch_of(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = ("flash_attention_lse", "flash_attention_bwd")
    reset_counts(names)
    rows = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, step,
                                       batches[step])
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, m["loss"].item(),
                     m["grad_norm"].item(), m["lr"]))
    counts = read_counts(names)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for step, (sec, loss, gn, lr) in enumerate(rows):
        log(f"  step {step}: {sec * 1e3:.1f} ms, loss {loss:.5f}, grad norm "
            f"{gn:.4f}, lr {lr:.3e}, optimizer "
            f"{opt_ms[step][0].elapsed_time(opt_ms[step][1]):.2f} ms")
    step_s = statistics.median(r[0] for r in rows[3:8])
    opt_med = statistics.median(s.elapsed_time(e) for s, e in opt_ms[3:8])
    flops = training_flops(model, params, TRAIN_B * TRAIN_S, TRAIN_B,
                           TRAIN_S)
    log(f"minitron-4b training ({cfg.num_layers} layers, B {TRAIN_B} x S "
        f"{TRAIN_S}, fp32 "
        f"masters, bf16, AdamW, remat): step {step_s * 1e3:.1f} ms (median "
        f"of steps 3-7), {TRAIN_B * TRAIN_S / step_s:.0f} tokens/s, "
        f"{flops / 1e12:.1f} TFLOP per step = {flops / step_s / 1e12:.1f} "
        f"TFLOP/s, {flops / step_s / BF16_FLOPS:.3f} of {BF16_FLOPS / 1e12:.0f} "
        f"(bound {flops / BF16_FLOPS * 1e3:.1f} ms); optimizer "
        f"{opt_med:.2f} ms; peak memory {peak:.2f} GiB; launches {counts} "
        f"({card})")
    profile_training_step(torch, lambda: step_fn(
        params, opt_state, TRAIN_STEPS, batches[0]), step_s)
    require(all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows),
            "minitron-4b training: a loss or grad norm is not finite")
    require(rows[-1][1] < rows[1][1],
            f"minitron-4b training: the last loss {rows[-1][1]:.5f} is not "
            f"below step 1's {rows[1][1]:.5f}")
    require(peak < 78, f"minitron-4b training: peak memory {peak:.2f} GiB")
    L = cfg.num_layers
    require(counts["flash_attention_bwd"] == L * TRAIN_STEPS
            and counts["flash_attention_lse"] >= L * TRAIN_STEPS,
            f"minitron-4b training launched {counts}")
    del model, params, opt_state, batches, step_fn
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts


# deepseek-v2-lite-16b training: the layer cut (the dense prologue layer
# and DS_TRAIN_LAYERS - 1 MoE layers) whose fp32 params, grads and AdamW
# moments (16 bytes a parameter, 68.5 GiB at 8) and the step's transients
# stay under 78 GiB; the full 27 layers would need about 250 GB
DS_TRAIN_LAYERS = 8
DS_CHECK_LAYERS = 2                 # the fp32 check: dense + one MoE layer
DS_TRAIN_KERNELS = ("flash_attention_lse_d192", "flash_attention_bwd_d192")


def moe_train_check(torch, model, params, batch, dtype: str, label: str):
    """Kernel path against plain path from the same params and batch, the
    routing pinned to the plain path's experts in the forward and in the
    remat recompute, held by ``hold_grads``.  Then the kernel path
    unpinned (its own routing) against the same plain run, logged and not
    failed, with its routing partings."""
    picks = {}
    with routing_pin(picks, "record"):
        loss_p, g_p = loss_and_grads(torch, model, params, batch, False)
    dec = params["decoder"]
    n_moe = sum("moe" in lp for lp in dec["prologue"] + dec["layers"])
    require(len(picks) == n_moe, f"{label}: {len(picks)} of {n_moe} MoE "
            f"layers routed")
    with routing_pin(picks, "pin") as st:
        kernel = loss_and_grads(torch, model, params, batch, True)
    hold_grads(kernel, (loss_p, g_p), dtype,
               f"{label} (routing pinned to the plain path's experts, "
               f"forward and remat recompute; the kernel path's own top-k "
               f"would have parted at {st['parted']} of {st['picks']} "
               f"(token, layer) picks)")
    del kernel
    with routing_pin(picks, "free") as st:
        loss_u, g_u = loss_and_grads(torch, model, params, batch, True)
    free = grad_distances(g_u, g_p)
    del g_u, g_p
    log(f"{label} unpinned (each path its own routing; logged, not failed): "
        f"loss relative {abs(loss_u - loss_p) / abs(loss_p):.3e}, largest "
        f"leaf relative norm {max(free):.3e}, median "
        f"{sorted(free)[len(free) // 2]:.3e}; routing parted at "
        f"{st['parted']} of {st['picks']} picks")


def moe_dispatch_ms(torch, model, lp, B: int, S: int):
    """Device ms of one MoE layer's pieces at the training step's shapes
    (bf16 activations, the layer's fp32 masters): the whole ``moe_apply``,
    its routed experts' products and its shared experts, each forward alone
    and forward plus backward.  Returns (dispatch forward, dispatch forward
    + backward): the layer less its experts, i.e. the router, capacity
    positions, one-hot dispatch and combine."""
    from repro_torch.models import moe as M
    from repro_torch.optim import tree_leaves
    cfg = model.cfg
    mo = cfg.moe
    gen = torch.Generator(device="cuda").manual_seed(6)
    E, C = mo.num_experts, M.capacity(mo, S)

    def act(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_(True)

    h, xe = act((B, S, cfg.d_model)), act((E, B * C, cfg.d_model))
    gy = torch.randn((B, S, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    ge = torch.randn((E, B * C, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    leaves = tree_leaves(lp["moe"])
    for p in leaves:
        p.requires_grad_(True)

    def moe_fb():
        y, aux = M.moe_apply(lp["moe"], cfg, h)
        torch.autograd.backward([y, aux], [gy, torch.full_like(aux, 0.01)])

    pieces = {
        "moe": (lambda: M.moe_apply(lp["moe"], cfg, h), moe_fb),
        "experts": (lambda: M._expert_ffn(lp["moe"]["experts"], cfg, xe),
                    lambda: M._expert_ffn(lp["moe"]["experts"], cfg,
                                          xe).backward(ge)),
        "shared": (lambda: M.ffn_apply(lp["moe"]["shared"], cfg, h),
                   lambda: M.ffn_apply(lp["moe"]["shared"], cfg,
                                       h).backward(gy))}
    ms = {}
    try:
        for name, (fwd, fwd_bwd) in pieces.items():
            with torch.no_grad():
                f = time_ms(torch, fwd, 5, 2)
            fb = time_ms(torch, fwd_bwd, 5, 2)
            ms[name] = (f, fb)
    finally:
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
    disp = [ms["moe"][i] - ms["experts"][i] - ms["shared"][i]
            for i in range(2)]
    log(f"deepseek MoE layer at B {B} x S {S} (bf16, capacity {C} per "
        f"expert and row): forward / forward + backward ms: whole "
        f"{ms['moe'][0]:.3f} / {ms['moe'][1]:.3f}, routed experts "
        f"{ms['experts'][0]:.3f} / {ms['experts'][1]:.3f}, shared "
        f"{ms['shared'][0]:.3f} / {ms['shared'][1]:.3f}; the dispatch "
        f"(router, capacity, one-hots, dispatch and combine einsums) "
        f"{disp[0]:.3f} / {disp[1]:.3f}")
    return disp[0], disp[1]


def run_deepseek_training_phase(torch):
    """Full-width deepseek-v2-lite-16b training on one card (fp32 masters,
    bf16 activations, AdamW, remat, the einsum dispatch, B 4 x S 1024 from
    the port's SyntheticLM) at a layer cut, ``DS_TRAIN_LAYERS`` of 27: (a)
    kernel vs plain path at ``DS_CHECK_LAYERS`` layers in fp32, (b) at the
    cut in bf16, both with the routing pinned to the plain path's experts
    (the unpinned distances and the routing partings logged), (c) 8 steps
    of make_train_step on the kernel path, timed: step ms, tokens/s, the
    share of 989 TFLOP/s with the routed experts' FLOPs (and the FLOPs the
    einsum dispatch executes), the optimizer's ms, peak memory and a
    profile by kind beside the dispatch's share.  Returns the D 192 flash
    kernels' launches over (c)."""
    import dataclasses
    import gc
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import moe as M
    from repro_torch.models.model import build_model
    from repro_torch.optim import Optimizer, make_optimizer, tree_leaves
    from repro_torch.train import TrainConfig, make_train_step

    card = card_line()
    full = get_config("deepseek-v2-lite-16b")
    pipe = make_pipeline(full, TRAIN_S, TRAIN_B, seed=0)

    def batch_of(step):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in pipe.batch(step).items()}

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (a) fp32 at 2 layers, on the empty card
    cfg2 = dataclasses.replace(full, num_layers=DS_CHECK_LAYERS,
                               dtype="float32")
    model = build_model(cfg2, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg2.param_dtype)
    moe_train_check(torch, model, params, batch_of(0), "float32",
                    f"training check deepseek-v2-lite-16b widths, "
                    f"{DS_CHECK_LAYERS} layers, fp32")
    del model, params
    free()

    # (b) bf16 at the cut
    cfg = dataclasses.replace(full, num_layers=DS_TRAIN_LAYERS)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.param_dtype)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    log(f"deepseek-v2-lite-16b training: cut to {DS_TRAIN_LAYERS} of "
        f"{full.num_layers} layers (the dense layer and "
        f"{DS_TRAIN_LAYERS - 1} MoE layers), {n / 1e9:.3f} B params as fp32 "
        f"masters ({16 * n / 2**30:.1f} GiB with grads and AdamW moments) in "
        f"{time.perf_counter() - t0:.2f} s; bf16 activations, AdamW, remat, "
        f"einsum dispatch, B {TRAIN_B} x S {TRAIN_S}")
    moe_train_check(torch, model, params, batch_of(0), "bfloat16",
                    f"training check deepseek-v2-lite-16b, {DS_TRAIN_LAYERS} "
                    f"layers, bf16")
    free()

    # (c) the kernel path's steps, the optimizer timed by CUDA events
    opt = make_optimizer(cfg.optimizer)
    opt_ms = []

    def timed_update(grads, state, params_, lr):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = opt.update(grads, state, params_, lr)
        e.record()
        opt_ms.append((s, e))
        return out

    tc = TrainConfig(steps=TRAIN_STEPS, lr=3e-4, warmup=2)
    step_fn = make_train_step(model, Optimizer(opt.init, timed_update), tc)
    opt_state = opt.init(params)
    batches = [batch_of(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(DS_TRAIN_KERNELS)
    rows = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, step,
                                       batches[step])
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, m["loss"].item(),
                     m["grad_norm"].item(), m["lr"], m["aux"].item()))
    counts = read_counts(DS_TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for step, (sec, loss, gn, lr, aux) in enumerate(rows):
        log(f"  step {step}: {sec * 1e3:.1f} ms, loss {loss:.5f} (aux "
            f"{aux:.5f}), grad norm {gn:.4f}, lr {lr:.3e}, optimizer "
            f"{opt_ms[step][0].elapsed_time(opt_ms[step][1]):.2f} ms")
    step_s = statistics.median(r[0] for r in rows[3:8])
    opt_med = statistics.median(s.elapsed_time(e) for s, e in opt_ms[3:8])
    T = TRAIN_B * TRAIN_S
    flops = training_flops(model, params, T, TRAIN_B, TRAIN_S)
    # what the einsum dispatch executes besides: every expert on its
    # capacity rows (E x C per batch row, not top_k per token) and the
    # dispatch and combine products (2 forward, 2 in the remat forward,
    # 3 in the backward: 7 of 2 T E C d each)
    mo = cfg.moe
    C = M.capacity(mo, TRAIN_S)
    n_moe = len(params["decoder"]["layers"])
    experts = sum(p.numel() for lp in params["decoder"]["layers"]
                  for p in tree_leaves(lp["moe"]["experts"]))
    executed = (flops + 8.0 * experts * (TRAIN_B * C - T * mo.top_k
                                         / mo.num_experts)
                + n_moe * 7 * 2.0 * T * mo.num_experts * C * cfg.d_model)
    log(f"deepseek-v2-lite-16b training ({DS_TRAIN_LAYERS} of "
        f"{full.num_layers} layers, B {TRAIN_B} x S {TRAIN_S}, fp32 masters, "
        f"bf16, AdamW, remat, einsum dispatch): step {step_s * 1e3:.1f} ms "
        f"(median of steps 3-7), {T / step_s:.0f} tokens/s, "
        f"{flops / 1e12:.1f} TFLOP per step counting the routed experts "
        f"(top-{mo.top_k} of {mo.num_experts} and {mo.num_shared_experts} "
        f"shared) = {flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / BF16_FLOPS:.3f} of {BF16_FLOPS / 1e12:.0f} "
        f"(bound {flops / BF16_FLOPS * 1e3:.1f} ms); the einsum dispatch "
        f"executes {executed / 1e12:.1f} TFLOP ({executed / flops:.2f}x: "
        f"every expert on its {C} capacity rows a batch row, and the "
        f"one-hot dispatch and combine products), "
        f"{executed / step_s / BF16_FLOPS:.3f} of the peak; optimizer "
        f"{opt_med:.2f} ms; peak memory {peak:.2f} GiB; launches {counts} "
        f"({card})")
    ms = profile_training_step(torch, lambda: step_fn(
        params, opt_state, TRAIN_STEPS, batches[0]), step_s)
    disp_f, disp_fb = moe_dispatch_ms(torch, model,
                                      params["decoder"]["layers"][0],
                                      TRAIN_B, TRAIN_S)
    dispatch = n_moe * (disp_f + disp_fb)
    if ms is not None:
        other = "other (elementwise, reductions, optimizer)"
        log(f"deepseek-v2-lite-16b training step by kind (ms): flash "
            f"forward {ms['flash forward']:.1f}, flash backward "
            f"{ms['flash backward']:.1f}, cuBLAS "
            f"{ms['matmul (cuBLAS)']:.1f}, of which and of other the MoE "
            f"dispatch (router, capacity, one-hot dispatch and combine; one "
            f"layer's forward + forward and backward timed alone x "
            f"{n_moe} layers) {dispatch:.1f}, AdamW (CUDA events) "
            f"{opt_med:.1f}, other less AdamW {ms[other] - opt_med:.1f} "
            f"({card})")
    require(all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows),
            "deepseek training: a loss or grad norm is not finite")
    require(rows[-1][1] < rows[1][1],
            f"deepseek training: the last loss {rows[-1][1]:.5f} is not "
            f"below step 1's {rows[1][1]:.5f}")
    require(peak < 78, f"deepseek training: peak memory {peak:.2f} GiB")
    require(DS_TRAIN_LAYERS >= 6, "deepseek training: the cut is under 6")
    require(counts["flash_attention_bwd_d192"] == DS_TRAIN_LAYERS * TRAIN_STEPS
            and counts["flash_attention_lse_d192"]
            >= DS_TRAIN_LAYERS * TRAIN_STEPS,
            f"deepseek training launched {counts}")
    del model, params, opt_state, batches, step_fn
    free()
    return counts


# SSM and hybrid training: hymba-1.5b at full width and depth, B 2 x S 2048
# (past its window of 1024: the window masks keys), the fp32 check at 3
# layers (global layer 0 and two windowed ones); falcon-mamba-7b at its
# published widths cut to 32 of 64 layers (fp32 masters, grads
# and AdamW moments, 16 bytes a parameter: 58.1 GiB at 32; the full 64
# would need 116 GB), B 4 x S 1024, the fp32 check at 2 layers
SSM_TRAIN = {"hymba-1.5b": dict(B=2, S=2048, layers=None, check=3),
             "falcon-mamba-7b": dict(B=4, S=1024, layers=32, check=2)}
SSM_TRAIN_KERNELS = ("mamba_scan_train", "mamba_scan_bwd",
                     "flash_attention_lse_window",
                     "flash_attention_bwd_window", "flash_attention_lse",
                     "flash_attention_bwd")


def ssm_floor_check(torch, model, params, batch, label: str):
    """The bf16 kernel path of an SSM or hybrid model held to the model's
    own bf16 rounding floor, measured in the same run on the same params
    and batch, as the serving checks hold falcon's and hymba's logits
    (``SSM_FLOOR_MARGIN``): each gradient leaf's relative norm distance
    from the fp32 plain path (the same fp32 masters, fp32 activations),
    for the kernel path and for the bf16 plain path; the kernel path's
    root mean square over the leaves may exceed the plain path's by at
    most the margin (a mean over hundreds of leaves, where the largest
    leaf is one draw of chaotic rounding: hymba's dt_proj read 6.4e-2
    kernel vs plain at 32 layers), and its loss is within
    ``TRAIN_TOL``'s of the plain path's.  Logs the largest and median
    leaf of each and the kernel path's distance from the plain path."""
    import dataclasses
    from repro_torch.models.model import build_model
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"), "cuda")
    loss32, g32 = loss_and_grads(torch, m32, params, batch, False)
    loss_k, g_k = loss_and_grads(torch, model, params, batch, True)
    d_k = grad_distances(g_k, g32)
    g_k = [g.cpu() for g in g_k]        # held on the host for the log
    loss_p, g_p = loss_and_grads(torch, model, params, batch, False)
    d_p = grad_distances(g_p, g32)
    del g32
    d_kp = [((a.to(b.device) - b).norm() / b.norm().clamp(min=1e-30)).item()
            for a, b in zip(g_k, g_p)]
    del g_k, g_p

    def rms(d):
        return math.sqrt(sum(x * x for x in d) / len(d))

    def spread(d):
        worst = max(range(len(d)), key=d.__getitem__)
        return (f"largest {d[worst]:.3e} (leaf {worst}), median "
                f"{sorted(d)[len(d) // 2]:.3e}, rms {rms(d):.3e}")

    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    limit = (1 + SSM_FLOOR_MARGIN) * rms(d_p)
    log(f"{label}: loss kernel {loss_k:.6f} plain {loss_p:.6f} fp32 plain "
        f"{loss32:.6f} (kernel vs plain relative {loss_rel:.3e}, tol "
        f"{TRAIN_TOL['bfloat16'][0]:.0e}); {len(d_k)} gradient leaves' "
        f"distance from fp32: kernel {spread(d_k)}; plain (the floor) "
        f"{spread(d_p)}; kernel rms {rms(d_k) / rms(d_p):.3f}x the floor's "
        f"(limit {1 + SSM_FLOOR_MARGIN:.2f}x = {limit:.3e}); kernel vs "
        f"plain {spread(d_kp)}")
    require(math.isfinite(loss_k) and loss_rel <= TRAIN_TOL["bfloat16"][0]
            and rms(d_k) <= limit,
            f"{label}: kernel path beyond the bf16 floor")


def run_ssm_training_phase(torch, arch: str):
    """Training of an SSM or hybrid model on one card (fp32 masters, bf16
    activations, AdamW, remat, ``SSM_TRAIN[arch]``'s batch from the port's
    SyntheticLM): (a) kernel vs plain path at the published widths cut to
    a few layers in fp32 (``hold_grads``), (b) at the phase's depth in
    bf16, held to the model's own rounding floor (``ssm_floor_check``),
    (c) 8 steps of make_train_step on the kernel path,
    timed: step ms, tokens/s, the share of 989 TFLOP/s, the optimizer's
    ms, peak memory, the step by kind.  Returns the launches over (c) of
    the scan's training kernels and, on a hybrid, the windowed flash
    kernels."""
    import dataclasses
    import gc
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models.model import build_model
    from repro_torch.optim import Optimizer, make_optimizer, tree_leaves
    from repro_torch.train import TrainConfig, make_train_step

    card = card_line()
    plan = SSM_TRAIN[arch]
    B, S_len = plan["B"], plan["S"]
    full = get_config(arch)
    L = plan["layers"] or full.num_layers
    pipe = make_pipeline(full, S_len, B, seed=0)

    def batch_of(step):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in pipe.batch(step).items()}

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (a) fp32 at a few layers, on the empty card
    cfg_c = dataclasses.replace(full, num_layers=plan["check"],
                                dtype="float32")
    model = build_model(cfg_c, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg_c.param_dtype)
    sliding = [i for i in range(cfg_c.num_layers)
               if full.attn_type == "sliding"
               and i not in full.global_attn_layers]
    train_path_check(torch, model, params, batch_of(0), "float32",
                     f"training check {arch} widths, {plan['check']} layers "
                     f"(windowed: {sliding}), fp32")
    del model, params
    free()

    # (b) bf16 at the phase's depth
    cfg = dataclasses.replace(full, num_layers=L)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.param_dtype)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    cut = f"cut to {L} of {full.num_layers} layers" if L < full.num_layers \
        else f"all {L} layers"
    log(f"{arch} training: {cut}, {n / 1e9:.3f} B params as fp32 masters "
        f"({16 * n / 2**30:.1f} GiB with grads and AdamW moments) in "
        f"{time.perf_counter() - t0:.2f} s; bf16 activations, AdamW, remat, "
        f"B {B} x S {S_len}")
    ssm_floor_check(torch, model, params, batch_of(0),
                    f"training check {arch}, {L} layers, bf16")
    free()

    # (c) the kernel path's steps, the optimizer timed by CUDA events
    opt = make_optimizer(cfg.optimizer)
    opt_ms = []

    def timed_update(grads, state, params_, lr):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = opt.update(grads, state, params_, lr)
        e.record()
        opt_ms.append((s, e))
        return out

    tc = TrainConfig(steps=TRAIN_STEPS, lr=3e-4, warmup=2)
    step_fn = make_train_step(model, Optimizer(opt.init, timed_update), tc)
    opt_state = opt.init(params)
    batches = [batch_of(s) for s in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(SSM_TRAIN_KERNELS)
    rows = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, step,
                                       batches[step])
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, m["loss"].item(),
                     m["grad_norm"].item(), m["lr"]))
    counts = read_counts(SSM_TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for step, (sec, loss, gn, lr) in enumerate(rows):
        log(f"  step {step}: {sec * 1e3:.1f} ms, loss {loss:.5f}, grad norm "
            f"{gn:.4f}, lr {lr:.3e}, optimizer "
            f"{opt_ms[step][0].elapsed_time(opt_ms[step][1]):.2f} ms")
    step_s = statistics.median(r[0] for r in rows[3:8])
    opt_med = statistics.median(s.elapsed_time(e) for s, e in opt_ms[3:8])
    T = B * S_len
    flops = training_flops(model, params, T, B, S_len)
    log(f"{arch} training ({cut}, B {B} x S {S_len}, fp32 masters, bf16, "
        f"AdamW, remat): step {step_s * 1e3:.1f} ms (median of steps 3-7), "
        f"{T / step_s:.0f} tokens/s, {flops / 1e12:.1f} TFLOP per step "
        f"(weight products and attention; the scan not counted) = "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / BF16_FLOPS:.3f} of {BF16_FLOPS / 1e12:.0f} "
        f"(bound {flops / BF16_FLOPS * 1e3:.1f} ms); optimizer "
        f"{opt_med:.2f} ms; peak memory {peak:.2f} GiB; launches {counts} "
        f"({card})")
    profile_training_step(torch, lambda: step_fn(
        params, opt_state, TRAIN_STEPS, batches[0]), step_s)
    require(all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows),
            f"{arch} training: a loss or grad norm is not finite")
    require(rows[-1][1] < min(rows[0][1], rows[1][1]),
            f"{arch} training: the last loss {rows[-1][1]:.5f} is not below "
            f"the first {rows[0][1]:.5f} and step 1's {rows[1][1]:.5f}")
    require(peak < 78, f"{arch} training: peak memory {peak:.2f} GiB")
    n_win = sum(1 for i in range(L) if full.attn_type == "sliding"
                and i not in full.global_attn_layers)
    n_glob = L - n_win if full.hybrid_parallel else 0
    steps = TRAIN_STEPS
    require(counts["mamba_scan_bwd"] == L * steps
            and counts["mamba_scan_train"] >= L * steps
            and counts["flash_attention_bwd_window"] == n_win * steps
            and counts["flash_attention_lse_window"] >= n_win * steps
            and counts["flash_attention_bwd"] == n_glob * steps,
            f"{arch} training launched {counts}")
    del model, params, opt_state, batches, step_fn
    free()
    return {k: counts[k] for k in SSM_TRAIN_KERNELS[:4]}


def profile_training_step(torch, run, wall: float):
    """Profile one training step ``run()`` (device activity only) and log
    its device time by kind and the busy share of the unprofiled step's
    ``wall`` (s): the union of the kernels' intervals.  Returns the ms by
    kind (None where the profiler recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # the backward's kernels, its split fold (flash_bwd_fold) included,
    # all carry the flash_bwd prefix
    kinds = {"flash backward": ("flash_bwd",),
             "flash forward": ("flash_attention_mma",),
             "scan backward": ("mamba_scan_bwd",),
             "scan forward": ("mamba_scan_kernel",),
             "matmul (cuBLAS)": ("gemm", "gemv", "nvjet", "xmma", "cutlass"),
             "other (elementwise, reductions, optimizer)": ("",)}
    ms = dict.fromkeys(kinds, 0.0)
    spans = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        low = ev.name.lower()
        kind = next(k for k, pats in kinds.items()
                    if any(pat in low for pat in pats))
        ms[kind] += (ev.time_range.end - ev.time_range.start) / 1e3
    union, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    if not spans:
        log("training step profile: the profiler recorded no device time "
            "(busy share not measured)")
        return None
    log(f"training step profile: device busy (union of kernel intervals) "
        f"{union / 1e3:.1f} ms of the unprofiled {wall * 1e3:.1f} ms step "
        f"(busy share {union / 1e3 / (wall * 1e3):.3f}); by kind (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
        + f" ({card_line()})")
    return ms


def run_trainer_phase(torch):
    """llama-100m through the launcher's restart loop in process: 30 steps
    at S 256, B 8 with checkpoints in a temporary directory; once
    uninterrupted, once with a preemption flag file written at step 10 and
    a resume from its checkpoint.  The resumed run's losses must equal the
    uninterrupted run's within 1e-3 relative, and its last loss must be
    below its first."""
    import tempfile
    from repro_torch.launch import train as launch_train

    names = ("flash_attention_lse", "flash_attention_bwd")
    runs = []
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for preempt in (False, True):
            losses = {}
            flag = Path(d) / "preempt"

            def on_step(step, m, preempt=preempt, losses=losses):
                losses.setdefault(step, m["loss"])
                if preempt and step == TRAINER_PREEMPT_AT:
                    flag.write_text("preempt")

            reset_counts(names)
            args = TRAINER_ARGS + ["--ckpt-dir", str(Path(d) / f"ck{preempt}")]
            if preempt:
                args += ["--preempt-file", str(flag)]
            rc = launch_train.main(args, on_step=on_step)
            counts = read_counts(names)
            require(rc == 0, f"train launcher returned {rc}")
            runs.append((losses, counts))
    (whole, c0), (resumed, c1) = runs
    steps = sorted(resumed)
    rel = max(abs(resumed[s] - whole[s]) / abs(whole[s]) for s in steps)
    log(f"trainer phase llama-100m (launcher loop, 30 steps, S 256, B 8, "
        f"preempted after step {TRAINER_PREEMPT_AT}, resumed from its "
        f"checkpoint): losses first {resumed[0]:.4f} last {resumed[29]:.4f}; "
        f"largest relative distance from the uninterrupted run {rel:.3e} "
        f"(tol 1e-3); launches uninterrupted {c0}, resumed {c1}; "
        f"{time.perf_counter() - t0:.1f} s with checkpoints")
    require(steps == list(range(30)) and sorted(whole) == steps,
            "trainer phase: steps missing")
    require(rel <= 1e-3, "trainer phase: the resumed run's losses differ")
    require(resumed[29] < resumed[0], "trainer phase: the loss did not fall")
    require(min(c0.values()) > 0 and min(c1.values()) > 0,
            "trainer phase: a training kernel never launched")


def encoder_jobs(cfg):
    """The encoder phase's 16 jobs of 64-2048 tokens, from seed 1."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(1, cfg.vocab_size, size=int(n))
            for n in rng.integers(64, 2049, size=16)]


def encode_all(torch, engine, jobs):
    """Every job through ``engine``; (embeddings in job order as an (n,
    d) fp32 tensor, wall seconds, steps)."""
    t0 = time.perf_counter()
    rids = [engine.submit(j) for j in jobs]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = engine.results()
    return torch.tensor([res[r] for r in rids]), wall, steps


def run_encoder_phase(torch):
    """qwen2.5-32b at its published widths, cut to 16 layers (random bf16
    weights from seed 0), through ``EncoderEngine``: 16 jobs of 64-2048
    tokens on the ladder (512, 1024, 2048), 8 jobs per step, warmed before
    the clock.  Logs sequences/s and the flash launches; the embeddings
    against the plain path's (within 5e-2 of each job's largest |value|:
    bf16 roundings at other points over 16 layers); and the largest
    difference of one job's embedding between the ladder and the
    capacity alone (2048), and whether it is bitwise: a finding, not a
    gate."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.workloads import EncoderEngine, ServeConfig
    cfg = dataclasses.replace(get_config("qwen2.5-32b"),
                              num_layers=ENCODER_LAYERS)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"qwen2.5-32b encoder: {cfg.param_count() / 1e9:.2f} B params "
        f"({ENCODER_LAYERS} of 64 layers at d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}), "
        f"random bf16 weights in {time.perf_counter() - t0:.2f} s")
    jobs = encoder_jobs(cfg)
    scfg = ServeConfig(**ENCODER_SERVE)
    encode_all(torch, EncoderEngine(model, params, scfg), jobs)   # warm-up
    engine = EncoderEngine(model, params, scfg)
    engine.warm_compile(None)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(("flash_attention",))
    emb, wall, steps = encode_all(torch, engine, jobs)
    launches = read_counts(("flash_attention",))
    peak = torch.cuda.max_memory_allocated() / 2**30
    hits = engine.stats()["bucket_hits"]
    log(f"encoder qwen2.5-32b: {len(jobs)} jobs of "
        f"{[len(j) for j in jobs]} tokens in {steps} steps, bucket hits "
        f"{hits}; {wall:.3f} s = {len(jobs) / wall:.2f} sequences/s, "
        f"{sum(len(j) for j in jobs) / wall:.0f} tokens/s; peak memory "
        f"{peak:.2f} GiB; launches {launches} ({card_line()})")
    require(emb.shape == (len(jobs), cfg.d_model)
            and bool(emb.isfinite().all().item()),
            "encoder embeddings missing or not finite")
    require(launches["flash_attention"] >= cfg.num_layers * steps,
            f"flash_attention launched {launches} in {steps} steps")
    plain = EncoderEngine(model, params, dataclasses.replace(
        scfg, use_kernels=False))
    ref, _, _ = encode_all(torch, plain, jobs)
    rel = ((emb - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
    log(f"encoder qwen2.5-32b: embeddings, kernel path against plain path, "
        f"max over jobs of max|d|/max|value| = {rel:.3e} (tol "
        f"{LOGIT_REL_TOL:.0e})")
    require(math.isfinite(rel) and rel <= LOGIT_REL_TOL,
            "encoder embeddings disagree with the plain path")
    full = EncoderEngine(model, params, dataclasses.replace(
        scfg, len_buckets=()))
    alone, _, _ = encode_all(torch, full, jobs)
    diff = (emb - alone).abs().max().item()
    log(f"encoder qwen2.5-32b: ladder (512, 1024, 2048) against the "
        f"capacity alone: largest |difference| of one job's embedding "
        f"{diff:.3e} (max |value| {alone.abs().max().item():.3e}), bitwise "
        f"equal {bool(torch.equal(emb, alone))} (a finding, not a gate)")
    del engine, plain, full, params
    gc.collect()
    torch.cuda.empty_cache()


def mixed_params(torch, names):
    """Random bf16 weights of the launcher's MIXED_FLEET, full width and
    the encoder tenant cut to ENCODER_LAYERS, tenant i from seed i."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import MIXED_FLEET
    from repro_torch.models.model import build_model
    params = {}
    for i, ((_, arch), name) in enumerate(zip(MIXED_FLEET, names)):
        cfg = get_config(arch)
        if arch == "qwen2.5-32b":
            cfg = dataclasses.replace(cfg, num_layers=ENCODER_LAYERS)
        params[name] = build_model(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(i))
    torch.cuda.synchronize()
    return params


def encdec_token_margin(torch, model, params, src, tokens, bos: int):
    """The top-2 margin, relative to its largest |logit|, of the logits
    that pick the enc-dec token after ``tokens``: the source encoded, then
    a prefill of [bos] + ``tokens``, the kernels on."""
    toks, lens = padded_sources(torch, [src], len(src))
    enc = model.encode(params, {"tokens": toks}, lens=lens)
    dec = torch.tensor([[bos] + list(tokens)], dtype=torch.int32,
                       device="cuda")
    logits, _ = model.prefill(
        params, {"tokens": dec}, model.init_cache(1, dec.shape[1] + 1,
                                                  src_len=len(src)),
        enc_out=enc, src_len=len(src))
    return top2_margin(model, logits)


def run_mixed_fleet_phase(torch):
    """The launcher's ``serve_fabric`` in process: ``--scenario
    flash-crowd`` over its MIXED_FLEET (minitron-4b decode, falcon-mamba-7b
    SSM, qwen2.5-32b encoder cut to 16 layers, seamless-m4t-medium enc-dec,
    all at published widths, random bf16 weights) on 8 CUs with paged KV at
    ``--kv-frac 0.4``.  Logs per-class throughput, TTFT p50/p99, the
    events, preemptions, the SLO attainment, captures on the serving path
    (0), peak memory and the serving kernels' launches inside the fleet
    (each must launch).  Then the slot-granular replay of the same schedule
    (``--kv-frac 1.0 --no-preempt``) on the same weights: every token
    stream must equal it but at counted near-ties (the replay's top-2
    margin below ARGMAX_MARGIN where they part)."""
    import gc

    from repro_torch.launch import serve as launcher
    args = launcher.parser().parse_args(MIXED_ARGS)
    names = [t.name for t in launcher.fleet_tenants(
        args, launcher.ServeConfig())]
    t0 = time.perf_counter()
    params = mixed_params(torch, names)
    log(f"mixed fleet: weights of {names} made in "
        f"{time.perf_counter() - t0:.2f} s; launcher args {MIXED_ARGS}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(MIXED_KERNELS)
    srv, doc, submitted = launcher.serve_fabric(args, params)
    launches = read_counts(MIXED_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    card = card_line()
    for e in doc["events"]:
        log(f"mixed fleet event step {e['step']} {e['reason']}: sizes "
            f"{e['sizes']}, retuned {e['retuned']}, design {e['design']}, "
            f"apply {e['seconds']} s, warm builds {e['warm_builds']}")
    for t, tp in doc["per_class_throughput"].items():
        ttft = doc["slo"]["tenants"].get(t, {}).get("ttft_ms", {})
        log(f"mixed fleet {t} ({tp['class']}): {tp['value']} "
            f"{tp['unit']}; TTFT p50 {ttft.get('p50')} ms, p99 "
            f"{ttft.get('p99')} ms; preemptions {doc['preemptions'][t]}; "
            f"captures on the serving path {doc['serving_captures'][t]}")
    log(f"mixed fleet: {doc['decode_steps']} steps in {doc['wall_s']} s, "
        f"harness step ms {doc['harness_step_ms']}, slo_preemptions "
        f"{doc['slo_preemptions']}, slo_attainment "
        f"{json.dumps(doc['slo_attainment'])}; peak memory {peak:.2f} GiB; "
        f"launches inside the fleet {launches} ({card})")
    require(set(doc["serving_captures"].values()) == {0},
            f"captures on the serving path: {doc['serving_captures']}")
    require(sum(doc["preemptions"].values()) >= 1, "no preemption")
    require(all(v["value"] > 0 for v in doc["per_class_throughput"].values()),
            "a class served nothing")
    for k in MIXED_KERNELS:
        require(launches[k] > 0, f"{k} never launched inside the fleet")
    res_a = srv.results()
    models = {t: (g._model, g.params) for t, g in srv.engines.items()}
    bos = srv.specs[names[3]].serve.bos_id
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    args_b = launcher.parser().parse_args(MIXED_ARGS + [
        "--kv-frac", "1.0", "--no-preempt"])
    srv_b, doc_b, _ = launcher.serve_fabric(args_b, params)
    res_b = srv_b.results()
    log(f"mixed fleet replay (slot-granular: --kv-frac 1.0 --no-preempt): "
        f"preemptions {doc_b['preemptions']}, digest "
        f"{doc_b['streams_digest'][:16]} against {doc['streams_digest'][:16]}")
    del srv_b
    gc.collect()
    ties = 0
    emb_rel = 0.0
    for t, rid, prompt in submitted:
        got, want = res_a[t][rid], res_b[t][rid]
        if doc["workload_classes"][t] == "encoder":
            a, b = torch.tensor(got), torch.tensor(want)
            require(a.shape == b.shape == (models[t][0].cfg.d_model,)
                    and bool(a.isfinite().all().item()),
                    f"{t} request {rid}: embedding missing")
            emb_rel = max(emb_rel, ((a - b).abs().max()
                                    / b.abs().max()).item())
            continue
        require(len(got) == len(want) == 32, f"{t} request {rid}: "
                f"{len(got)} and {len(want)} tokens, want 32")
        if got == want:
            continue
        p = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        model, prm = models[t]
        if doc["workload_classes"][t] == "encdec":
            margin = encdec_token_margin(torch, model, prm, prompt,
                                         want[:p], bos)
        else:
            margin = first_token_margin(torch, model, prm, prompt, want[:p])
        ties += 1
        log(f"mixed fleet {t} request {rid}: parts from the replay at token "
            f"{p} ({got[p]} vs {want[p]}); the replay's top-2 margin there "
            f"{margin:.3e}")
        require(margin < ARGMAX_MARGIN, f"mixed fleet {t} request {rid} "
                "parts from the slot-granular replay away from a near-tie")
    log(f"mixed fleet: paged streams equal the slot-granular replay's but "
        f"for {ties} near-tie(s); digests equal "
        f"{doc['streams_digest'] == doc_b['streams_digest']}; encoder "
        f"embeddings, largest max|d|/max|value| between the runs "
        f"{emb_rel:.3e}")
    del params, models
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

def path_logits(torch, paths, *, steps: int = 5, S: int = 100):
    """fp32 logits of each path on one S-token prompt and after each of
    ``steps`` decode steps, every path fed the last path's argmax.  A path
    is (model, params, use_kernels).  Returns, per position, the list of
    the paths' logits over the vocabulary only: the padding columns hold
    -1e30 (hymba pads 32001 to 32256), which would swamp a comparison
    relative to the largest |logit|."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    V = paths[0][0].cfg.vocab_size
    toks = torch.randint(1, V, (1, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    caches = [m.init_cache(1, S + steps + 3) for m, _, _ in paths]
    logits = [None] * len(paths)
    for i, (m, p, kern) in enumerate(paths):
        logits[i], caches[i] = m.prefill(p, {"tokens": toks}, caches[i],
                                         use_kernels=kern)
    out = [[x.float()[..., :V] for x in logits]]
    for _ in range(steps):
        nxt = logits[-1].argmax(-1).to(torch.int32)[:, None]
        for i, (m, p, kern) in enumerate(paths):
            logits[i], caches[i] = m.decode_step(p, caches[i], nxt,
                                                 use_kernels=kern)
        out.append([x.float()[..., :V] for x in logits])
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


def run_reference_check(torch, path_a, path_b, *, tol, label, S=100):
    """Path a against path b, both fed b's argmax, from an S-token prompt.
    Fails when max|a - b| / max|b| exceeds ``tol`` at any position, or the
    argmax parts where b's top-2 margin is not below min(tol,
    ARGMAX_MARGIN).  Returns the largest relative difference."""
    worst, parted = 0.0, 0
    rows = path_logits(torch, (path_a, path_b), S=S)
    for step, (a, b) in enumerate(rows):
        rel = rel_err(a, b)
        same, margin, ok = argmax_check(a, b, min(tol, ARGMAX_MARGIN))
        log(f"{label} step {step}: max|dlogit|/max|logit| = {rel:.3e} "
            f"(tol {tol:.0e}), argmax equal {same}, top-2 margin of b "
            f"{margin:.3e}")
        require(math.isfinite(rel) and rel <= tol and ok,
                f"{label}: the two paths disagree at step {step}")
        worst = max(worst, rel)
        parted += not same
    log(f"{label}: largest {worst:.3e}; argmax partings {parted} of "
        f"{len(rows)} positions, each at a top-2 margin under "
        f"{min(tol, ARGMAX_MARGIN):.0e}")
    return worst


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_fp32(v) for v in tree]
    return tree.float()


def run_ssm_reference_checks(torch, model, S: int = 100):
    """An SSM model (falcon-mamba-7b, hymba-1.5b) at full depth, for each
    weight seed of ``SSM_CHECK_SEEDS``: four paths on the same tokens (an
    S-token prompt, 5 steps), the kernel and the plain path in bf16 and on
    an fp32 copy of the same weights.  In fp32
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
        label = f"reference check {model.cfg.name} seed {seed}"
        paths = ((model, params, True), (model, params, False),
                 (m32, p32, True), (m32, p32, False))
        worst = dict.fromkeys(("kernel bf16", "plain bf16",
                               "bf16 kernel vs plain", "fp32 kernel vs plain"),
                              0.0)
        for step, (k16, p16, k32, f32) in enumerate(
                path_logits(torch, paths, S=S)):
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

    if "--flash-baseline" in sys.argv:
        others = [Path(p) for p in sys.argv[sys.argv.index(
            "--flash-baseline") + 1:]]
        run_flash_compare(torch, others)
        run_flash_bwd_compare(torch, others)
        print(card_line(), flush=True)
        return 0

    if "--scan-baseline" in sys.argv:
        log_scan_build()
        run_scan_compare(torch, [Path(p) for p in sys.argv[sys.argv.index(
            "--scan-baseline") + 1:]])
        print(card_line(), flush=True)
        return 0

    start = time.perf_counter()
    phase_s = lambda: f"{time.perf_counter() - start:.1f} s"
    kernels = run_kernel_phase(torch)
    kernels.update(run_flash_bwd_phase(
        torch, torch.Generator(device="cuda").manual_seed(4), 10))
    kernels.update(run_ssm_kernel_phase(torch))
    kernels.update(run_scan_train_phase(torch))
    kernels.update(run_window_flash_phase(torch))
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

    # the enc-dec and encoder classes, then the launcher's four-class fleet
    launches.update(run_encdec_phase(torch))
    log(f"enc-dec phase done at {phase_s()}")
    run_encoder_phase(torch)
    log(f"encoder phase done at {phase_s()}")
    run_mixed_fleet_phase(torch)
    log(f"mixed-fleet phase done at {phase_s()}")

    # MLA and MoE: full-width deepseek-v2-lite-16b through the decode engine
    launches.update(run_deepseek_phase(torch))
    log(f"deepseek phase done at {phase_s()}")

    # the last serving families, on the card that deepseek left empty
    launches.update(run_granite_phase(torch))
    log(f"granite phase done at {phase_s()}")
    run_hymba_phase(torch)
    log(f"hymba phase done at {phase_s()}")

    # training: full-width minitron-4b on the empty card, then the
    # launcher's loop with a preemption and a resume
    launches.update(run_training_phase(torch))
    log(f"training phase done at {phase_s()}")
    launches.update(run_deepseek_training_phase(torch))
    log(f"deepseek training phase done at {phase_s()}")
    # SSM and hybrid training: hymba-1.5b whole, falcon-mamba-7b at its cut
    for arch in SSM_TRAIN:
        for name, n in run_ssm_training_phase(torch, arch).items():
            launches[name] = launches.get(name, 0) + n
        log(f"{arch} training phase done at {phase_s()}")
    run_trainer_phase(torch)
    log(f"trainer phase done at {phase_s()}")

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
