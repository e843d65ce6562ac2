"""Mamba decode step and prefill selective scan: the CUDA kernels' wrappers.

Replace the Pallas kernels of ``src/repro/kernels/mamba_scan/kernel.py``:
``mamba_step_kernel`` (every decode step of every layer, from
``models/ssm.py:mamba_step``) and ``mamba_scan`` (every layer's prefill,
from ``models/ssm.py:mamba_prefill``, in place of the reference's chunked
jnp scan).  The step is bound by its weight bytes.  It is eight launches
behind one call (in_proj, conv, x_proj, dt/B/C, dt_proj, recurrence,
out_proj, out; csrc/mamba_scan.cu has the design).  In bf16 each weight
product streams its weight once for up to 32 slot rows, on the tensor
cores, in one even pass over the card that ``plan()`` cuts from host ints;
the launches overlap (programmatic dependent launch).  fp32, and bf16
rows that are not 16-byte aligned, take a CUDA-core product that streams
the weights once per 8 slot rows.  The scan loops over time inside the
block: a producer warp keeps 64-step tiles of x, dt, B and C in flight
(one tensor-map copy per input and tile) while the other warps scan, 4 of
a channel's states per lane in registers, each exponential one MUFU.EX2;
``scan_plan()`` spreads the channels evenly over the card from host ints.

Tensor parallelism: a rank holds a slice of the d_in channels, and the
step's two sums over them (x_proj's, out_proj's) are partial.
``mamba_step_staged`` runs the step in the kernel's staged entry: stage A
(in_proj, conv, x_proj) leaves x_proj's fp32 sum over the rank's channels,
the caller's ``reduce`` adds the ranks' sums on the stream, stage B
(dbc rounded, dt_proj, the state update, out_proj) leaves out_proj's, and
after the second sum the finish rounds it.  ``mamba_step_stage_a``,
``mamba_step_stage_b`` and ``mamba_step_finish`` are the three launches
(``staged_step_launches`` counts stage A's); a one-rank group takes
``mamba_step``.

Training: ``SelectiveScanFn`` is the reference's ``fused_selective_scan``
custom VJP (``models/ssm.py:_fss_fwd`` / ``_fss_bwd``).  Its forward
launches the scan with its boundary output (the state before every
``SCAN_CHUNK``-th step, ``scan_train_launches``), and its backward
``mamba_scan_bwd`` (``scan_bwd_launches``): blocks of 256 threads, 4
of a channel's states a lane, walk the chunks in reverse; each chunk's
inputs arrive by ``cp.async`` while the chunk before sweeps, its states
are recomputed from the saved boundary into registers one 8-step
sub-chunk at a time and swept back for (dx, ddt, dB, dC, dA, dD).  dB
and dC sum over every channel: a thread-block cluster of up to 8 blocks
along the channels adds its blocks' sums through distributed shared
memory, and a second launch adds the clusters' partials in a fixed order
(csrc/mamba_scan.cu has the design).  ``scan_bwd_plan()`` picks the
cluster and the grid from host ints and mirrors the kernel's shared
memory and residency.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises; a ``meta`` tensor (the dry run) gives the outputs'
shapes and reports the kernel's work, by the formula of its bound, to
``repro_torch.analysis.opcount`` (the step: every slot live).
``step_launches``, ``staged_step_launches``, ``scan_launches``,
``scan_train_launches`` and ``scan_bwd_launches`` count the calls that
launched a kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (SCAN_CHUNK, mamba_scan_ref,
                                                mamba_step_a_ref,
                                                mamba_step_b_ref,
                                                mamba_step_ref,
                                                selective_scan_bwd_ref,
                                                selective_scan_fwd_ref)

step_launches = 0
staged_step_launches = 0
scan_launches = 0
scan_train_launches = 0
scan_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATE_DIMS = (4, 8, 16)      # N the kernels are compiled for
_MAX_CONV = 8                 # conv width the step kernel takes
_ROWS = 8                     # slot rows one CUDA-core product block holds
_MIN_SPLIT_K = 256            # fewest K rows a CUDA-core product block sums
# the tensor-core product (csrc/mamba_scan.cu, kMma*): 64-column strips,
# 128-row ring stages, 128 threads, up to 32 slot rows a pass
_BN, _BK, _THREADS, _PASS_ROWS = 64, 128, 128, 32
_MIN_SPAN = 2                 # fewest ring stages a K split streams
_FILL = 2                     # blocks per SM a split product aims at
_SM_SMEM = 233472             # shared memory per H100 SM (228 KB)
_BLOCK_SMEM = 1024            # reserved by the hardware per block
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FMA, _MMA = 0, 1             # csrc Route
overlap = True                # launch the step's kernels overlapped (PDL)
_SCAN_STATES = 4              # states a scan lane holds (csrc kScanStates)
_SCAN_CHANNELS = tuple(range(8, 65, 8))   # csrc kScanMaxChannels = 64
_BWD_THREADS = 256            # threads of a backward block (csrc kBwdThreads)
_BWD_SUB = 8                  # steps a sub-chunk holds in registers (kBwdSub)
_BWD_STAGES = 2               # chunks a backward block stages (kBwdStages)
_BWD_MAX_CLUSTER = 8          # blocks a cluster, at most (kBwdMaxCluster)
_BWD_MAX_WARPS = 16           # backward warps an SM holds, at most
_CLUSTERS = (1, 2, 4, 8)      # cluster sizes a backward launch may take


@functools.lru_cache(maxsize=1)
def _step_fn():
    fn = _build.load_library().mamba_step
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 18 + [_I] * 6 + [_L] * 3 + [_I] * 2 + [_P]
    return fn


@functools.lru_cache(maxsize=1)
def _stage_fn():
    fn = _build.load_library().mamba_step_stage
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] + [_P] * 20 + [_I] * 6 + [_L] * 3 + [_I] * 2 + [_P]
    return fn


@functools.lru_cache(maxsize=1)
def _scan_fn():
    fn = _build.load_library().mamba_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_L] * 8 + [_I] * 2 + [_P]
    return fn


@functools.lru_cache(maxsize=1)
def _scan_bwd_fn():
    fn = _build.load_library().mamba_scan_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 16 + [_I] * 4 + [_L] * 8 + [_I] * 2 + [_P]
    return fn


@functools.lru_cache(maxsize=1)
def _scan_bwd_occupancy_fn():
    fn = _build.load_library().mamba_scan_bwd_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [_I] * 3 + [_P]
    return fn


class ProductPlan(NamedTuple):
    """How one skinny product ``(B, K) @ (K, N)`` is cut: ``route`` 1 is
    the tensor-core product, 0 the CUDA-core one; ``splits`` of ``span``
    K rows each (one split: the product writes its rounded result, else
    fp32 partials that the next launch sums in split order); ``grid``
    blocks walk ``items`` = strips x splits work items (tensor cores)."""
    route: int
    splits: int
    span: int
    grid: int
    items: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def resident(rows: int) -> int:
    """Tensor-core product blocks one SM holds for a pass of ``rows`` slot
    rows: its shared memory is the ring of weight and x stages."""
    nt = 1 if rows <= 8 else 2 if rows <= 16 else 4
    stages = 6 if nt == 1 else 4               # csrc mma_stages()
    smem = stages * (_BK * _BN * 2 + nt * 8 * (_BK * 2 + 16))
    return min(2048 // _THREADS, _SM_SMEM // (smem + _BLOCK_SMEM))


@functools.lru_cache(maxsize=None)
def plan(B: int, K: int, N: int, sms: int = 132) -> ProductPlan:
    """The tensor-core plan of ``(B, K) @ (K, N)`` on ``sms`` SMs, from
    host ints alone.  Work items are (64-column strip, K span), all of one
    size but the ragged edges.  K is split only where the strips alone
    give fewer items than SMs; then into equal spans of at least
    ``_MIN_SPAN`` stages, the count chosen to come closest to ``_FILL``
    items per SM with every SM's item count within one of the others,
    fewest splits on a tie.  Every item is resident at once where the
    card holds them; else ``grid`` is a whole number of blocks per SM and
    each block walks every grid-th item."""
    strips, steps = _ceil(N, _BN), max(1, _ceil(K, _BK))
    cap = resident(min(B, _PASS_ROWS)) * sms

    def score(items: int) -> float:
        fill = min(items, _FILL * sms) / (_FILL * sms)
        return fill * items / (_ceil(items, sms) * sms)

    span, splits = steps, 1
    if strips < sms and steps >= 2 * _MIN_SPAN:
        best = score(strips)
        for s in range(2, steps // _MIN_SPAN + 1):
            sp = _ceil(steps, s)
            if _ceil(steps, sp) != s:      # spans would not be equal
                continue
            if strips * s > cap:
                break
            if score(strips * s) > best:
                best, span, splits = score(strips * s), sp, s
    items = strips * splits
    return ProductPlan(_MMA, splits, span * _BK, min(items, cap), items)


class ScanPlan(NamedTuple):
    """How one scan is cut: ``channels`` per block, ``blocks`` per row
    (grid.x), ``grid`` blocks in all, and ``per_sm``: the most blocks any
    SM gets when they are dealt out evenly."""
    channels: int
    blocks: int
    grid: int
    per_sm: int


@functools.lru_cache(maxsize=None)
def scan_plan(B: int, D: int, N: int, sms: int = 132) -> ScanPlan:
    """The scan's plan for B rows of D channels and N states on ``sms``
    SMs, from host ints alone.  Every block scans all S steps of its
    channels, so an SM's time is the channels it gets: the channels per
    block (a multiple of 8 up to 64) minimise the most any SM gets,
    ceil(blocks / sms) x channels, and the largest such block wins a tie;
    a block's consumers are whole warps of N / 4 lanes per channel (one
    producer warp joins them).
    At B = 1, d_in = 8192: 128 blocks of 64 channels, one per SM."""
    load = lambda ch: _ceil(B * _ceil(D, ch), sms) * ch
    whole = [ch for ch in _SCAN_CHANNELS if ch * N // _SCAN_STATES % 32 == 0]
    ch = min(whole, key=lambda ch: (load(ch), -ch))
    blocks = _ceil(D, ch)
    return ScanPlan(ch, blocks, B * blocks, _ceil(B * blocks, sms))


def _splits(B: int, K: int, N: int, vec_cols: int, sms: int) -> int:
    """K splits of one CUDA-core product, so that about two blocks per SM
    stream its weight: column tiles x row groups x splits >= 2 x SMs."""
    tile = 8 * (vec_cols if N % vec_cols == 0 else 1)
    blocks = -(-N // tile) * -(-B // _ROWS)
    want = -(-2 * sms // blocks)
    splits = max(1, min(want, K // _MIN_SPLIT_K))
    return -(-K // -(-K // splits))


def _product_plan(B, K, N, ldx, x_ptr, w, sms) -> ProductPlan:
    """The tensor-core plan where the kernel takes the operands (bf16, rows
    and x 16-byte aligned), else the CUDA-core one."""
    if (w.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
            and ldx % 8 == 0 and x_ptr % 16 == 0 and w.data_ptr() % 16 == 0):
        return plan(B, K, N, sms)
    splits = _splits(B, K, N, 16 // w.element_size(), sms)
    return ProductPlan(_FMA, splits, _ceil(K, splits), 0, 0)


def _need(cond: bool, what: str, exc=ValueError) -> None:
    if not cond:
        raise exc(what)


def _check_step(x1, conv, h, live, weights, fp32s):
    dev = x1.device
    tensors = (x1, conv, h, live) + weights + fp32s
    _need(all(t.device == dev for t in tensors),
          "mamba_step: every tensor must lie on one CUDA device")
    act = x1.dtype
    _need(act in _DTYPES and conv.dtype == act and all(
        w.dtype == act for w in weights),
        f"mamba_step takes float32 or bfloat16 x1, conv and weights of one "
        f"dtype, got {x1.dtype}, {conv.dtype}, "
        f"{[w.dtype for w in weights]}", TypeError)
    _need(h.dtype == torch.float32 and all(
        t.dtype == torch.float32 for t in fp32s),
        "mamba_step takes h, conv_w, conv_b, dt_bias, A_log and D in fp32",
        TypeError)
    _need(x1.is_contiguous() and all(w.is_contiguous() for w in weights)
          and all(t.is_contiguous() for t in fp32s),
          "mamba_step needs contiguous x1, weights and fp32 parameters")
    B, _, d_in = conv.shape
    N = h.shape[2]
    _need(N in _STATE_DIMS, f"state_dim {N} is not one of {_STATE_DIMS}")
    _need(conv.shape[1] + 1 <= _MAX_CONV,
          f"conv width {conv.shape[1] + 1} exceeds {_MAX_CONV}")
    _need(conv.stride(2) == 1 and h.stride(2) == 1 and h.stride(1) == N
          and h.data_ptr() % 16 == 0 and h.stride(0) % 4 == 0,
          f"conv and h need a unit channel/state stride and 16-byte aligned "
          f"state rows, got strides {conv.stride()} and {h.stride()}")
    _need(h.shape[:2] == (B, d_in) and x1.shape[0] == B
          and live.shape == (B,), "mamba_step: row counts disagree")


def _step_shapes(x1, conv, h, in_proj, conv_w, x_proj, dt_proj, a_log,
                 out_proj):
    """(B, d_model, d_in, R, N, w) of a step, its weight shapes checked."""
    B, _, d_model = x1.shape
    d_in, N = h.shape[1], h.shape[2]
    R = dt_proj.shape[0]
    w = conv.shape[1] + 1
    _need(in_proj.shape == (d_model, 2 * d_in)
          and x_proj.shape == (d_in, R + 2 * N)
          and dt_proj.shape == (R, d_in) and out_proj.shape == (d_in, d_model)
          and conv_w.shape == (w, d_in) and a_log.shape == (d_in, N),
          "mamba_step: weight shapes disagree with x1, conv and h")
    return B, d_model, d_in, R, N, w


def _step_plans(x2, weights, B, d_model, d_in, wdbc, R, sms):
    """The four products' plans (in_proj, x_proj, dt_proj, out_proj) and
    their output widths."""
    in_proj, x_proj, dt_proj, out_proj = weights
    plans = [_product_plan(B, d_model, 2 * d_in, d_model, x2.data_ptr(),
                           in_proj, sms),
             _product_plan(B, d_in, wdbc, d_in, 0, x_proj, sms),
             _product_plan(B, R, d_in, wdbc, 0, dt_proj, sms),
             _product_plan(B, d_in, d_model, d_in, 0, out_proj, sms)]
    return plans, (2 * d_in, wdbc, d_in, d_model)


def _scratch(plans, widths, B, which, fp32_out, dev, act_dtype):
    """The fp32 partials and the activation-dtype direct outputs of the
    products ``which`` (indices into ``plans``); those in ``fp32_out``
    write partials whatever their plan."""
    direct = {i: plans[i].route == _MMA and plans[i].splits == 1
              and i not in fp32_out for i in which}
    part = torch.empty(max(1, sum(plans[i].splits * B * widths[i]
                                  for i in which if not direct[i])),
                       dtype=torch.float32, device=dev)
    prod = torch.empty(max(1, sum(_ceil(B * widths[i], 8) * 8
                                  for i in which if direct[i])),
                       dtype=act_dtype, device=dev)
    return part, prod


def mamba_step(x1, conv, h, in_proj, conv_w, conv_b, x_proj, dt_proj,
               dt_bias, a_log, d, out_proj, *, live=None):
    """One decode token through a Mamba block.  x1: (B, 1, d_model); conv:
    (B, w-1, d_in) and h: (B, d_in, N) fp32, both updated IN PLACE for the
    live rows; live: optional (B,) bool -> out (B, 1, d_model).  Dead rows
    output zeros and their conv and h stay bit for bit unchanged."""
    global step_launches
    args = (in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, a_log, d,
            out_proj)
    if x1.device.type == "cpu":
        out, new_conv, new_h = mamba_step_ref(x1, conv, h, *args, live=live)
        conv.copy_(new_conv)
        h.copy_(new_h)
        return out
    if x1.device.type == "meta":
        from repro_torch.analysis import opcount, roofline
        B, _, d_model = x1.shape
        nbytes, flops, _ = roofline.mamba_step_work(
            B, d_model, h.shape[1], dt_proj.shape[0], h.shape[2],
            conv.shape[1] + 1, x1.element_size(), B)
        opcount.kernel("mamba_step", flops, nbytes)
        return torch.empty((B, 1, d_model), dtype=x1.dtype, device=x1.device)
    B, _, d_model = x1.shape
    live_i = _live_rows(live, B, x1.device)
    weights = (in_proj, x_proj, dt_proj, out_proj)
    fp32s = (conv_w, conv_b, dt_bias, a_log, d)
    x2 = x1.reshape(B, d_model)
    _check_step(x2, conv, h, live_i, weights, fp32s)
    B, d_model, d_in, R, N, w = _step_shapes(x1, conv, h, in_proj, conv_w,
                                             x_proj, dt_proj, a_log, out_proj)
    sms = _build.sm_count(x1.device.index or 0)
    wdbc = R + 2 * N
    plans, widths = _step_plans(x2, weights, B, d_model, d_in, wdbc, R, sms)
    dev, act_dtype = x1.device, x1.dtype
    part, prod = _scratch(plans, widths, B, range(4), (), dev, act_dtype)
    act = torch.empty(3 * _ceil(B * d_in, 8) * 8 + B * wdbc,
                      dtype=act_dtype, device=dev)
    out = torch.empty((B, 1, d_model), dtype=act_dtype, device=dev)
    plan_arg = (ctypes.c_int * 16)(*(v for p in plans for v in p[:4]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _step_fn()(
        x2.data_ptr(), conv.data_ptr(), h.data_ptr(), live_i.data_ptr(),
        in_proj.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
        x_proj.data_ptr(), dt_proj.data_ptr(), dt_bias.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), out_proj.data_ptr(), out.data_ptr(),
        part.data_ptr(), prod.data_ptr(), act.data_ptr(),
        ctypes.addressof(plan_arg), B, d_model, d_in, R, N, w,
        conv.stride(0), conv.stride(1), h.stride(0), int(overlap),
        _DTYPES[act_dtype], stream)
    _build.check(err, "mamba_step")
    step_launches += 1
    return out


def _live_rows(live, B: int, device):
    """(B,) int32 live flags on ``device`` (every row live by default)."""
    if live is None:
        return torch.ones(B, dtype=torch.int32, device=device)
    return live.to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# the staged step: one rank's channels of a tensor-parallel group
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepStage:
    """What a staged step carries from stage A to stage B and the finish:
    its tensors (x1, conv, h and the weights, as ``mamba_step`` takes
    them), the rows' live flags, and the activations stage A leaves: on
    the card the scratch that holds x_conv and z (stage B adds y and the
    rounded dbc), on the CPU x_conv and z themselves."""

    args: tuple
    live: Any
    act: Optional[torch.Tensor] = None
    x_conv: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None

    def activations(self):
        """(x_conv, z), each (B, d_in) in x1's dtype, as stage A left
        them (views of the card's scratch)."""
        if self.act is None:
            return self.x_conv, self.z
        B, d_in = self.args[0].shape[0], self.args[2].shape[1]
        n = _ceil(B * d_in, 8) * 8
        return (self.act[:B * d_in].view(B, d_in),
                self.act[n:n + B * d_in].view(B, d_in))


def _stage_launch(stage: int, st: StepStage, *, dbc=None, out_sum=None,
                  out=None, which=(), fp32_out=()):
    """Launch one stage of ``mamba_step_stage`` on ``st``'s tensors."""
    (x1, conv, h, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, a_log,
     d, out_proj) = st.args
    B, d_model, d_in, R, N, w = _step_shapes(x1, conv, h, in_proj, conv_w,
                                             x_proj, dt_proj, a_log, out_proj)
    weights = (in_proj, x_proj, dt_proj, out_proj)
    x2 = x1.reshape(B, d_model)
    dev, act_dtype = x1.device, x1.dtype
    plans, widths = _step_plans(x2, weights, B, d_model, d_in, R + 2 * N, R,
                                _build.sm_count(dev.index or 0))
    part, prod = _scratch(plans, widths, B, which, fp32_out, dev, act_dtype)
    plan_arg = (ctypes.c_int * 16)(*(v for p in plans for v in p[:4]))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _stage_fn()(
        stage, x2.data_ptr(), conv.data_ptr(), h.data_ptr(),
        st.live.data_ptr(), in_proj.data_ptr(), conv_w.data_ptr(),
        conv_b.data_ptr(), x_proj.data_ptr(), dt_proj.data_ptr(),
        dt_bias.data_ptr(), a_log.data_ptr(), d.data_ptr(),
        out_proj.data_ptr(), ptr(out), ptr(dbc), ptr(out_sum),
        part.data_ptr(), prod.data_ptr(), st.act.data_ptr(),
        ctypes.addressof(plan_arg), B, d_model, d_in, R, N, w,
        conv.stride(0), conv.stride(1), h.stride(0), int(overlap),
        _DTYPES[act_dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"mamba_step_stage {stage}")


def mamba_step_stage_a(x1, conv, h, in_proj, conv_w, conv_b, x_proj,
                       dt_proj, dt_bias, a_log, d, out_proj, *, live=None):
    """Stage A of the staged step on a rank's d_in channels (arguments as
    ``mamba_step``'s, the weights this rank's shards; ``in_proj`` (d_model,
    2 d_in) its x columns then its z columns): in_proj, the conv (the
    window advances in place for live rows) and x_proj -> (dbc (B, R + 2N)
    fp32, x_proj's sum over these channels, unrounded; the ``StepStage``
    that stage B takes).  ``staged_step_launches`` counts the calls that
    launched it."""
    global staged_step_launches
    args = (x1, conv, h, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias,
            a_log, d, out_proj)
    B = x1.shape[0]
    if x1.device.type == "cpu":
        dbc, x_conv, z, new_conv = mamba_step_a_ref(x1, conv, in_proj,
                                                    conv_w, conv_b, x_proj)
        st = StepStage(args, live, x_conv=x_conv, z=z)
        _keep_dead(conv, new_conv, live)
        return dbc, st
    _need(x1.device.type == "cuda", "mamba_step_stage_a takes CPU or CUDA "
          "tensors")
    live_i = _live_rows(live, B, x1.device)
    _check_step(x1.reshape(B, -1), conv, h, live_i,
                (in_proj, x_proj, dt_proj, out_proj),
                (conv_w, conv_b, dt_bias, a_log, d))
    d_in, N, R = h.shape[1], h.shape[2], dt_proj.shape[0]
    st = StepStage(args, live_i, act=torch.empty(
        3 * _ceil(B * d_in, 8) * 8 + B * (R + 2 * N), dtype=x1.dtype,
        device=x1.device))
    dbc = torch.empty((B, R + 2 * N), dtype=torch.float32, device=x1.device)
    _stage_launch(0, st, dbc=dbc, which=(0, 1), fp32_out=(1,))
    staged_step_launches += 1
    return dbc, st


def mamba_step_stage_b(dbc, st: StepStage):
    """Stage B from ``dbc``, x_proj's fp32 sum over every rank's channels
    (B, R + 2N): dbc rounded, dt_proj, the state update (h advances in
    place for live rows) and out_proj -> (B, d_model) fp32, out_proj's sum
    over this rank's channels, unrounded."""
    x1, _, h = st.args[:3]
    dt_proj, dt_bias, a_log, d, out_proj = st.args[7:]
    B, d_model = x1.shape[0], x1.shape[2]
    if x1.device.type == "cpu":
        out, h_new = mamba_step_b_ref(dbc, st.x_conv, st.z, h, dt_proj,
                                      dt_bias, a_log, d, out_proj)
        _keep_dead(h, h_new, st.live)
        return out
    _need(dbc.dtype == torch.float32 and dbc.is_contiguous()
          and dbc.shape == (B, dt_proj.shape[0] + 2 * h.shape[2]),
          "mamba_step_stage_b takes stage A's (B, R + 2N) fp32 sum")
    out = torch.empty((B, d_model), dtype=torch.float32, device=x1.device)
    _stage_launch(1, st, dbc=dbc, out_sum=out, which=(2, 3), fp32_out=(3,))
    return out


def mamba_step_finish(out_sum, st: StepStage):
    """The step's output from ``out_sum``, out_proj's fp32 sum over every
    rank's channels (B, d_model): rounded to x1's dtype, dead rows zeros
    -> (B, 1, d_model)."""
    x1 = st.args[0]
    B, d_model = x1.shape[0], x1.shape[2]
    if x1.device.type == "cpu":
        out = out_sum.to(x1.dtype)[:, None]
        if st.live is not None:
            lv = st.live.to(dtype=torch.bool)[:, None, None]
            out = torch.where(lv, out, torch.zeros_like(out))
        return out
    _need(out_sum.dtype == torch.float32 and out_sum.is_contiguous()
          and out_sum.shape == (B, d_model),
          "mamba_step_finish takes stage B's (B, d_model) fp32 sum")
    out = torch.empty((B, 1, d_model), dtype=x1.dtype, device=x1.device)
    _stage_launch(2, st, out_sum=out_sum, out=out)
    return out


def _keep_dead(state, new, live) -> None:
    """Copy ``new`` into ``state`` in place for the live rows."""
    if live is not None:
        lv = live.to(device=state.device, dtype=torch.bool)
        new = torch.where(lv.view(-1, *([1] * (state.ndim - 1))), new, state)
    state.copy_(new)


def mamba_step_staged(x1, conv, h, in_proj, conv_w, conv_b, x_proj, dt_proj,
                      dt_bias, a_log, d, out_proj, *, live=None,
                      reduce: Callable = None):
    """``mamba_step`` on one rank's d_in channels of a tensor-parallel
    group: stage A, ``reduce(dbc)`` (the group's all-reduce of x_proj's
    fp32 sum, in place, on the current stream), stage B,
    ``reduce(out_sum)``, the finish.  Nothing waits on the host, so a
    decode graph captures it.  Arguments and result as ``mamba_step``'s,
    the weights this rank's shards."""
    dbc, st = mamba_step_stage_a(x1, conv, h, in_proj, conv_w, conv_b,
                                 x_proj, dt_proj, dt_bias, a_log, d,
                                 out_proj, live=live)
    if reduce is not None:
        reduce(dbc)
    out_sum = mamba_step_stage_b(dbc, st)
    if reduce is not None:
        reduce(out_sum)
    return mamba_step_finish(out_sum, st)


def _check_scan(x, dt, b, c, a_log, d, what: str):
    B, S, D = x.shape
    N = b.shape[-1]
    _need(all(t.device == x.device for t in (dt, b, c, a_log, d)),
          f"{what}: every tensor must lie on one CUDA device")
    _need(x.dtype in _DTYPES and b.dtype == c.dtype == x.dtype
          and dt.dtype == a_log.dtype == d.dtype == torch.float32,
          f"{what} takes x, b, c of float32 or bfloat16 and dt, A_log, "
          f"D in fp32, got {x.dtype}, {b.dtype}, {c.dtype}, {dt.dtype}, "
          f"{a_log.dtype}, {d.dtype}", TypeError)
    _need(N in _STATE_DIMS, f"state_dim {N} is not one of {_STATE_DIMS}")
    _need(dt.shape == (B, S, D) and b.shape == c.shape == (B, S, N)
          and a_log.shape == (D, N) and d.shape == (D,),
          f"{what}: shapes disagree")
    _need(all(t.stride(-1) == 1 for t in (x, dt, b, c))
          and a_log.is_contiguous() and d.is_contiguous(),
          f"{what} needs a unit stride on the last axis")


def mamba_scan(x, dt, b, c, a_log, d, *, bounds: bool = False):
    """Selective scan of a prefill from a zero state.  x: (B, S, D) in the
    activation dtype; dt: (B, S, D) fp32, already softplus'd; b, c: (B, S,
    N) in the activation dtype (strided views are taken as they are);
    a_log: (D, N) and d: (D,) fp32 -> (y (B, S, D) fp32, h_last (B, D, N)
    fp32).  Any S.  With ``bounds`` (training) a third output, the state
    before every ``SCAN_CHUNK``-th step, (ceil(S / SCAN_CHUNK), B, D, N)
    fp32, from the kernel's training instance (``scan_train_launches``);
    a CPU tensor then takes ``selective_scan_fwd_ref``."""
    global scan_launches, scan_train_launches
    if x.device.type == "cpu":
        y, h_last = mamba_scan_ref(x, dt, b, c, a_log, d)
        if bounds:
            return (y, h_last,
                    selective_scan_fwd_ref(x, dt, b, c, a_log, d)[1])
        return y, h_last
    B, S, D = x.shape
    N = b.shape[-1]
    dev = x.device
    _check_scan(x, dt, b, c, a_log, d, "mamba_scan")
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    bnd = (torch.empty((_ceil(S, SCAN_CHUNK), B, D, N), dtype=torch.float32,
                       device=dev) if bounds else None)
    if dev.type == "meta":
        from repro_torch.analysis import opcount, roofline
        es = x.element_size()
        if bounds:
            fwd, _, _, flops, _ = roofline.scan_train_work(B, S, D, N, es)
            opcount.kernel("mamba_scan_train", flops, fwd)
            return y, h_last, bnd
        nbytes, _, flops = roofline.scan_work(B, S, D, N, es)
        opcount.kernel("mamba_scan", flops, nbytes)
        return y, h_last
    p = scan_plan(B, D, N, _build.sm_count(dev.index or 0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _scan_fn()(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        None if bnd is None else bnd.data_ptr(),
        B, S, D, N, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1), p.channels,
        _DTYPES[x.dtype], stream)
    _build.check(err, "mamba_scan")
    if bnd is None:
        scan_launches += 1
        return y, h_last
    scan_train_launches += 1
    return y, h_last, bnd


class ScanBwdPlan(NamedTuple):
    """How one scan backward is cut: ``channels`` per block (4 of a
    channel's N states a lane, 256 lanes), ``blocks`` per row that hold
    channels, ``cluster`` blocks a thread-block cluster, the row's
    ``grid_x`` blocks (whole clusters; those past d_in idle),
    ``clusters`` per row (the partials' axis), ``sub`` steps a sub-chunk,
    the block's ``smem`` bytes, the ``resident`` blocks and ``warps`` an
    SM holds, and the ``waves`` of clusters the grid takes."""
    channels: int
    blocks: int
    cluster: int
    grid_x: int
    clusters: int
    sub: int
    smem: int
    resident: int
    warps: int
    waves: int


def scan_bwd_smem(N: int, es: int) -> int:
    """Shared memory of a backward block (csrc scan_bwd_smem(), dynamic,
    and scan_bwd_static_smem()): two stages of a chunk's dt, gy, boundary
    states (fp32), x, B and C (``es`` bytes); B and C in fp32; the
    block's (two chunks) and the warps' dB/dC sums."""
    ch = _BWD_THREADS * _SCAN_STATES // N
    stage = (4 * (2 * SCAN_CHUNK * ch + ch * N)
             + es * (SCAN_CHUNK * ch + 2 * SCAN_CHUNK * N))
    return (_BWD_STAGES * stage
            + 4 * SCAN_CHUNK * 2 * N * (1 + 2 + _BWD_THREADS // 32))


def bwd_resident(N: int, es: int) -> int:
    """Backward blocks one SM holds: as many as the shared memory takes,
    at most 16 warps, and one at N < 16 (csrc bwd_blocks_per_sm()).  The
    launch bounds ask the registers for the same count, so they never
    bind first."""
    cap = _BWD_MAX_WARPS * 32 // _BWD_THREADS if N == 16 else 1
    return min(cap, _SM_SMEM // (scan_bwd_smem(N, es) + _BLOCK_SMEM))


def _cluster_slots(slots: int, c: int) -> int:
    """Clusters of ``c`` blocks the card holds at once, out of ``slots``
    blocks, where the card was not asked: a cluster lies within one GPC,
    and clusters of 4 or more lose about 1/16 of the slots to the GPCs'
    edges (an H100 holds 124 of 4 and 62 of 8 in 528 slots, 62 and 30 in
    264)."""
    return slots // c if c <= 2 else slots * 15 // 16 // c


@functools.lru_cache(maxsize=None)
def scan_bwd_plan(B: int, D: int, N: int, sms: int = 132, es: int = 2,
                  cluster_slots: tuple = None) -> ScanBwdPlan:
    """The scan backward's plan for B rows of D channels and N states on
    ``sms`` SMs, inputs of ``es`` bytes, from host ints alone: blocks of
    1024 / N channels; the largest cluster (8, 4, 2 or 1 blocks, or all
    of a row's blocks where they are fewer than 8) that keeps the grid
    in as few waves as single blocks take, so that the fold costs no
    tail; the row padded to whole clusters.  ``cluster_slots``: clusters
    of 1, 2, 4 and 8 blocks the card holds at once (``bwd_cluster_slots``),
    else ``_cluster_slots``' estimate.
    At falcon-mamba-7b's training layer (4, 8192, 16): 128 blocks of 64
    channels a row, 2 waves of single blocks on 264 slots; clusters of 8
    or 4 would take 3, so clusters of 2: 64 partials a row.  At
    hymba-1.5b's (2, 3200, 16): 50 blocks a row in one wave, clusters of
    8, padded to 56: 7 partials a row."""
    ch = _BWD_THREADS * _SCAN_STATES // N
    blocks = _ceil(D, ch)
    resident = bwd_resident(N, es)
    slots = sms * resident
    waves = _ceil(B * blocks, slots)
    for c in sorted({min(_BWD_MAX_CLUSTER, blocks), 4, 2, 1}, reverse=True):
        held = (cluster_slots[_CLUSTERS.index(c)]
                if cluster_slots and c in _CLUSTERS
                else _cluster_slots(slots, c))
        if c <= blocks and _ceil(B * _ceil(blocks, c), held) <= waves:
            break
    clusters = _ceil(blocks, c)
    return ScanBwdPlan(ch, blocks, c, clusters * c, clusters, _BWD_SUB,
                       scan_bwd_smem(N, es), resident,
                       resident * _BWD_THREADS // 32, waves)


def bwd_occupancy(N: int, cluster: int, dtype) -> dict:
    """What the card makes of the backward instance at (N, ``dtype``):
    ``blocks_per_sm`` (the occupancy calculator's), ``smem`` bytes a
    block, ``registers`` and ``local_bytes`` (spills) a thread, and
    ``clusters`` of ``cluster`` blocks the card holds at once."""
    out = (ctypes.c_int * 5)()
    err = _scan_bwd_occupancy_fn()(N, cluster, _DTYPES[dtype],
                                   ctypes.addressof(out))
    _build.check(err, "mamba_scan_bwd_occupancy")
    return dict(zip(("blocks_per_sm", "smem", "registers", "local_bytes",
                     "clusters"), out))


@functools.lru_cache(maxsize=None)
def bwd_cluster_slots(N: int, dtype) -> tuple:
    """Clusters of 1, 2, 4 and 8 blocks of the backward instance at (N,
    ``dtype``) that the card holds at once (the occupancy calculator's)."""
    return tuple(bwd_occupancy(N, c, dtype)["clusters"] for c in _CLUSTERS)


def bwd_plan(B: int, D: int, N: int, dtype, device=None) -> ScanBwdPlan:
    """``scan_bwd_plan`` for a launch on CUDA ``device`` (default the
    current one) with its SM count and cluster slots."""
    index = torch.device(device or "cuda").index
    index = torch.cuda.current_device() if index is None else index
    return scan_bwd_plan(B, D, N, _build.sm_count(index),
                         dtype.itemsize,
                         bwd_cluster_slots(N, dtype))


def mamba_scan_bwd(x, dt, b, c, a_log, d, bounds, gy):
    """The gradients of ``mamba_scan``'s y for ``gy`` (B, S, D), from the
    forward's inputs and its ``bounds``: (dx (B, S, D) in x's dtype, ddt
    (B, S, D) fp32, dB and dC (B, S, N) contiguous in b's dtype, dA (D, N)
    fp32 with respect to A = -exp(A_log), dD (D,) fp32).  A CUDA tensor
    launches the kernel on ``scan_bwd_plan``'s grid, (grid_x, B) blocks
    of 256 threads in clusters of ``cluster``, with fp32 scratch of the
    clusters' dB/dC partials (B, clusters, S, 2N) and the rows' dA/dD (B,
    D, N + 1), then the launch that folds them.  A CPU tensor takes
    ``selective_scan_bwd_ref``."""
    global scan_bwd_launches
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, b, c, a_log, d, bounds, gy)
    B, S, D = x.shape
    N = b.shape[-1]
    dev = x.device
    _check_scan(x, dt, b, c, a_log, d, "mamba_scan_bwd")
    gy = gy.to(torch.float32).contiguous()
    _need(gy.shape == (B, S, D) and gy.device == dev,
          f"mamba_scan_bwd: gy {tuple(gy.shape)} must be x's {(B, S, D)}")
    _need(bounds.shape == (_ceil(S, SCAN_CHUNK), B, D, N)
          and bounds.dtype == torch.float32 and bounds.is_contiguous()
          and bounds.device == dev,
          f"mamba_scan_bwd: bounds {tuple(bounds.shape)} {bounds.dtype} "
          f"are not the forward's")
    dx = torch.empty((B, S, D), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, S, N), dtype=c.dtype, device=dev)
    da = torch.empty((D, N), dtype=torch.float32, device=dev)
    dd = torch.empty((D,), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        from repro_torch.analysis import opcount, roofline
        _, nbytes, _, _, flops = roofline.scan_train_work(
            B, S, D, N, x.element_size())
        opcount.kernel("mamba_scan_bwd", flops, nbytes)
        return dx, ddt, db, dc, da, dd
    p = bwd_plan(B, D, N, x.dtype, dev)
    part = torch.empty((B, p.clusters, S, 2 * N), dtype=torch.float32,
                       device=dev)
    dpart = torch.empty((B, D, N + 1), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _scan_bwd_fn()(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), bounds.data_ptr(), gy.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), dd.data_ptr(), part.data_ptr(), dpart.data_ptr(),
        B, S, D, N, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1), p.cluster,
        _DTYPES[x.dtype], stream)
    _build.check(err, "mamba_scan_bwd")
    scan_bwd_launches += 1
    return dx, ddt, db, dc, da, dd


class SelectiveScanFn(torch.autograd.Function):
    """The selective scan with its gradient, the reference's
    ``fused_selective_scan``: (x, dt, b, c, a_log, d) -> y (B, S, D) fp32,
    saving the inputs and the boundary states.  ``plain`` (or a CPU
    tensor) runs the plain pair, ``selective_scan_fwd_ref`` and
    ``selective_scan_bwd_ref``; else the kernels.  The gradient for
    ``a_log`` is dA A (A = -exp(A_log)); b and c may be strided views
    (of the x_proj output), their gradients come back contiguous.  It
    takes plain tensors only: on a mesh each rank calls it on its own rows
    and channels (``partitioning.channel_local``), and a DTensor raises."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a_log, d, plain=False):
        from torch.distributed.tensor import DTensor

        _need(not any(isinstance(t, DTensor)
                      for t in (x, dt, b, c, a_log, d)),
              "SelectiveScanFn takes each rank's local tensors, not "
              "DTensors: run it through partitioning.channel_local",
              TypeError)
        ctx.plain = plain or x.device.type == "cpu"
        if ctx.plain:
            y, bnd = selective_scan_fwd_ref(x, dt, b, c, a_log, d)
        else:
            y, _, bnd = mamba_scan(x, dt, b, c, a_log, d, bounds=True)
        ctx.save_for_backward(x, dt, b, c, a_log, d, bnd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, dt, b, c, a_log, d, bnd = ctx.saved_tensors
        bwd = selective_scan_bwd_ref if ctx.plain else mamba_scan_bwd
        dx, ddt, db, dc, da, dd = bwd(x, dt, b, c, a_log, d, bnd, gy)
        a = -torch.exp(a_log.float())
        return dx, ddt, db, dc, (da * a).to(a_log.dtype), dd.to(d.dtype), \
            None
