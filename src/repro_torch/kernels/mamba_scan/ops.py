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

Training: ``SelectiveScanFn`` is the reference's ``fused_selective_scan``
custom VJP (``models/ssm.py:_fss_fwd`` / ``_fss_bwd``).  Its forward
launches the scan with its boundary output (the state before every
``SCAN_CHUNK``-th step, ``scan_train_launches``), and its backward
``mamba_scan_bwd`` (``scan_bwd_launches``): a kernel that recomputes each
chunk's states from its boundary and sweeps it back for (dx, ddt, dB, dC,
dA, dD), with a second launch that folds the blocks' partials of the
cross-channel sums in a fixed order (csrc/mamba_scan.cu has the design).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``step_launches``, ``scan_launches``,
``scan_train_launches`` and ``scan_bwd_launches`` count the calls that
launched a kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import (SCAN_CHUNK, mamba_scan_ref,
                                                mamba_step_ref,
                                                selective_scan_bwd_ref,
                                                selective_scan_fwd_ref)

step_launches = 0
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
_BWD_THREADS = 128            # threads of a backward block (csrc kBwdThreads)


@functools.lru_cache(maxsize=1)
def _step_fn():
    fn = _build.load_library().mamba_step
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 18 + [_I] * 6 + [_L] * 3 + [_I] * 2 + [_P]
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
    fn.argtypes = [_P] * 16 + [_I] * 4 + [_L] * 8 + [_I, _P]
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
    B, _, d_model = x1.shape
    live_i = (torch.ones(B, dtype=torch.int32, device=x1.device)
              if live is None
              else live.to(device=x1.device, dtype=torch.int32).contiguous())
    weights = (in_proj, x_proj, dt_proj, out_proj)
    fp32s = (conv_w, conv_b, dt_bias, a_log, d)
    x2 = x1.reshape(B, d_model)
    _check_step(x2, conv, h, live_i, weights, fp32s)
    d_in, N = h.shape[1], h.shape[2]
    R = dt_proj.shape[0]
    w = conv.shape[1] + 1
    _need(in_proj.shape == (d_model, 2 * d_in)
          and x_proj.shape == (d_in, R + 2 * N)
          and dt_proj.shape == (R, d_in) and out_proj.shape == (d_in, d_model)
          and conv_w.shape == (w, d_in) and a_log.shape == (d_in, N),
          "mamba_step: weight shapes disagree with x1, conv and h")
    sms = _build.sm_count(x1.device.index or 0)
    wdbc = R + 2 * N
    plans = [_product_plan(B, d_model, 2 * d_in, d_model, x2.data_ptr(),
                           in_proj, sms),
             _product_plan(B, d_in, wdbc, d_in, 0, x_proj, sms),
             _product_plan(B, R, d_in, wdbc, 0, dt_proj, sms),
             _product_plan(B, d_in, d_model, d_in, 0, out_proj, sms)]
    widths = (2 * d_in, wdbc, d_in, d_model)
    direct = [p.route == _MMA and p.splits == 1 for p in plans]
    dev, act_dtype = x1.device, x1.dtype
    part = torch.empty(max(1, sum(p.splits * B * n for p, n, dr in zip(
        plans, widths, direct) if not dr)), dtype=torch.float32, device=dev)
    prod = torch.empty(max(1, sum(_ceil(B * n, 8) * 8 for n, dr in zip(
        widths, direct) if dr)), dtype=act_dtype, device=dev)
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


def bwd_channels(N: int) -> int:
    """Channels of one backward block: 128 threads, N / 4 lanes a
    channel."""
    return _BWD_THREADS * _SCAN_STATES // N


def mamba_scan_bwd(x, dt, b, c, a_log, d, bounds, gy):
    """The gradients of ``mamba_scan``'s y for ``gy`` (B, S, D), from the
    forward's inputs and its ``bounds``: (dx (B, S, D) in x's dtype, ddt
    (B, S, D) fp32, dB and dC (B, S, N) contiguous in b's dtype, dA (D, N)
    fp32 with respect to A = -exp(A_log), dD (D,) fp32).  A CPU tensor
    takes ``selective_scan_bwd_ref``."""
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
    blocks = _ceil(D, bwd_channels(N))
    dx = torch.empty((B, S, D), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, S, N), dtype=c.dtype, device=dev)
    da = torch.empty((D, N), dtype=torch.float32, device=dev)
    dd = torch.empty((D,), dtype=torch.float32, device=dev)
    part = torch.empty((B, blocks, S, 2 * N), dtype=torch.float32,
                       device=dev)
    dpart = torch.empty((B, D, N + 1), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _scan_bwd_fn()(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), bounds.data_ptr(), gy.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), dd.data_ptr(), part.data_ptr(), dpart.data_ptr(),
        B, S, D, N, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
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
    (of the x_proj output), their gradients come back contiguous."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a_log, d, plain=False):
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
