"""Mamba decode step and prefill selective scan: the CUDA kernels' wrappers.

Replace the Pallas kernels of ``src/repro/kernels/mamba_scan/kernel.py``:
``mamba_step_kernel`` (every decode step of every layer, from
``models/ssm.py:mamba_step``) and ``mamba_scan`` (every layer's prefill,
from ``models/ssm.py:mamba_prefill``, in place of the reference's chunked
jnp scan).  The step is bound by its weight bytes: it streams each weight
once for all slot rows, in eight launches behind one call (in_proj,
conv, x_proj, dt/B/C, dt_proj, recurrence, out_proj, out; csrc/mamba_scan.cu
has the design).  The scan keeps the state in registers and loops over
time inside the block.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``step_launches`` and ``scan_launches`` count the
calls that launched a kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref, mamba_step_ref

step_launches = 0
scan_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATE_DIMS = (4, 8, 16)      # N the kernels are compiled for
_MAX_CONV = 8                 # conv width the step kernel takes
_ROWS = 8                     # slot rows one product block holds
_MIN_SPLIT_K = 256            # fewest K rows a product block sums
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def _step_fn():
    fn = _build.load_library().mamba_step
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 16 + [_I] * 6 + [_L] * 3 + [_I] * 5 + [_P]
    return fn


@functools.lru_cache(maxsize=1)
def _scan_fn():
    fn = _build.load_library().mamba_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 8 + [_I] * 4 + [_L] * 8 + [_I, _P]
    return fn


def _splits(B: int, K: int, N: int, vec_cols: int, sms: int) -> int:
    """K splits of one skinny product, so that about two blocks per SM
    stream its weight: column tiles x row groups x splits >= 2 x SMs."""
    tile = 8 * (vec_cols if N % vec_cols == 0 else 1)
    blocks = -(-N // tile) * -(-B // _ROWS)
    want = -(-2 * sms // blocks)
    splits = max(1, min(want, K // _MIN_SPLIT_K))
    return -(-K // -(-K // splits))


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
    vec = 16 // x1.element_size()
    sms = _build.sm_count(x1.device.index or 0)
    products = ((d_model, 2 * d_in), (d_in, R + 2 * N), (R, d_in),
                (d_in, d_model))
    splits = [_splits(B, K, Nc, vec, sms) for K, Nc in products]
    part = torch.empty(max(s * B * Nc for s, (_, Nc) in zip(splits, products)),
                       dtype=torch.float32, device=x1.device)
    act = torch.empty(B * (3 * d_in + R + 2 * N), dtype=x1.dtype,
                      device=x1.device)
    out = torch.empty((B, 1, d_model), dtype=x1.dtype, device=x1.device)
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    err = _step_fn()(
        x2.data_ptr(), conv.data_ptr(), h.data_ptr(), live_i.data_ptr(),
        in_proj.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
        x_proj.data_ptr(), dt_proj.data_ptr(), dt_bias.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), out_proj.data_ptr(), out.data_ptr(),
        part.data_ptr(), act.data_ptr(), B, d_model, d_in, R, N, w,
        conv.stride(0), conv.stride(1), h.stride(0), *splits,
        _DTYPES[x1.dtype], stream)
    _build.check(err, "mamba_step")
    step_launches += 1
    return out


def mamba_scan(x, dt, b, c, a_log, d):
    """Selective scan of a prefill from a zero state.  x: (B, S, D) in the
    activation dtype; dt: (B, S, D) fp32, already softplus'd; b, c: (B, S,
    N) in the activation dtype (strided views are taken as they are);
    a_log: (D, N) and d: (D,) fp32 -> (y (B, S, D) fp32, h_last (B, D, N)
    fp32).  Any S."""
    global scan_launches
    if x.device.type == "cpu":
        return mamba_scan_ref(x, dt, b, c, a_log, d)
    B, S, D = x.shape
    N = b.shape[-1]
    dev = x.device
    _need(all(t.device == dev for t in (dt, b, c, a_log, d)),
          "mamba_scan: every tensor must lie on one CUDA device")
    _need(x.dtype in _DTYPES and b.dtype == c.dtype == x.dtype
          and dt.dtype == a_log.dtype == d.dtype == torch.float32,
          f"mamba_scan takes x, b, c of float32 or bfloat16 and dt, A_log, "
          f"D in fp32, got {x.dtype}, {b.dtype}, {c.dtype}, {dt.dtype}, "
          f"{a_log.dtype}, {d.dtype}", TypeError)
    _need(N in _STATE_DIMS, f"state_dim {N} is not one of {_STATE_DIMS}")
    _need(dt.shape == (B, S, D) and b.shape == c.shape == (B, S, N)
          and a_log.shape == (D, N) and d.shape == (D,),
          "mamba_scan: shapes disagree")
    _need(all(t.stride(-1) == 1 for t in (x, dt, b, c))
          and a_log.is_contiguous() and d.is_contiguous(),
          "mamba_scan needs a unit stride on the last axis")
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _scan_fn()(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_log.data_ptr(), d.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        B, S, D, N, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        _DTYPES[x.dtype], stream)
    _build.check(err, "mamba_scan")
    scan_launches += 1
    return y, h_last
