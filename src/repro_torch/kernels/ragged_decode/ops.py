"""Ragged decode attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/ragged_decode/kernel.py``
(``ragged_decode_kernel`` / ``_decode_kernel``), called on every decode step
from ``gqa_step``, for any query group G = Hq / Hkv, as the Pallas block
takes.  On the H100 the kernel is bound by the KV bytes of the live rows.
It splits each slot's KV rows into chunks and a KV head's G query heads
into groups of at most 8 (``head_groups``), one block per (slot, chunk, KV
head, head group) that holds rows to read, so the serving shape fills the
card; the last block of each (slot, KV head, head group) merges the chunks
(csrc/ragged_decode.cu has the design).  ``split_plan`` picks the chunk
and the grid from host ints alone, and ``ragged_decode_split_ref`` in
``ref.py`` is the same split and merge in plain PyTorch.

A call on the card is one launch and one ``torch.empty`` for the output
and the fp32 scratch: the kernel reads ``lengths`` (int32 or int64,
clamped to [1, T] on the card) and ``live`` (bool or integer) as the
engine hands them over, and keeps its merge tickets, ``ticket_count`` of
them, in a buffer zeroed once per device and stream (a CUDA graph's
capture gets one of its own, ``use_tickets``).  A CPU tensor takes the
plain version (``ref.py``); a CUDA tensor launches the kernel or raises;
a ``meta`` tensor (the dry run) gives the output's shape and reports the
kernel's work to ``repro_torch.analysis.opcount``.  ``launches`` counts
wrapper calls that launched the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import numbers

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_decode.ref import (head_groups,
                                                   ragged_decode_attention_ref)

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LEN_SIZES = {torch.int32: 4, torch.int64: 8}       # bytes the kernel reads
_LIVE_SIZES = {**_LEN_SIZES, torch.bool: 1, torch.uint8: 1, torch.int8: 1}
_MAX_ROW_BYTES = 512          # one KV row over at most 32 lanes of 16 bytes
_BLOCKS_PER_SM = 8            # split target: launched blocks per SM
_MIN_CHUNK = 32               # KV rows per chunk, a multiple of this
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.lru_cache(maxsize=1)
def _fn():
    fn = _build.load_library().ragged_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 9 + [_I] * 10 + [_L] * 9 + [_I, _I, _L, _I, _I,
                                                      _I, _F, _I, _P]
    return fn


def ticket_count(B: int, Hq: int, Hkv: int) -> int:
    """Merge tickets one launch over B slots takes: one per (slot, KV
    head, head group)."""
    return B * Hkv * head_groups(Hq // Hkv)[0]


def split_plan(B: int, Hq: int, Hkv: int, T: int, sms: int):
    """(chunk, n_split) for a (B, T, Hkv, D) cache view read by Hq query
    heads, on a card of ``sms`` SMs: chunks of a multiple of 32 rows, as
    many as give about ``_BLOCKS_PER_SM`` blocks per SM over the B * Hkv *
    groups (slot, KV head, head group) units, the groups those of
    ``head_groups(Hq // Hkv)``.  Depends on host ints only, never on the
    lengths."""
    groups = head_groups(Hq // Hkv)[0]
    per_block = -(-T * B * Hkv * groups // (_BLOCKS_PER_SM * sms))
    chunk = max(_MIN_CHUNK, -(-per_block // _MIN_CHUNK) * _MIN_CHUNK)
    return chunk, -(-T // chunk)


# per (device, stream): the kernel's (slot, KV head, head group) tickets,
# int32 zeros that every launch leaves at zero
_tickets: dict = {}


def _ticket_buffer(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"ragged_decode_attention: no ticket buffer of {n} for the "
                "capturing stream; give the capture one (use_tickets)")
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


@contextlib.contextmanager
def use_tickets(buf, stream: int):
    """Launches on ``stream`` take ``buf`` (int32 zeros) as their tickets
    inside the block.  A CUDA graph captured there keeps the buffer's
    address, so the caller keeps ``buf`` as long as the graph: its
    replays then share tickets with no eager call and no other graph.
    ``buf`` None leaves the stream's buffer as it is."""
    if buf is None:
        yield
        return
    key = (buf.device.index, stream)
    prev = _tickets.get(key)
    _tickets[key] = buf
    try:
        yield
    finally:
        if prev is None:
            _tickets.pop(key, None)
        else:
            _tickets[key] = prev


def _check(q1, k, v):
    """Raise on what the kernel does not take."""
    B, Hq, D = q1.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q1.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if not (q1.device == k.device == v.device) or k.device.type != "cuda":
        raise ValueError("q, k and v must lie on one CUDA device")
    if q1.dtype not in _DTYPES or not (q1.dtype == k.dtype == v.dtype):
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q1.dtype}, {k.dtype}, {v.dtype}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    row = D * q1.element_size()
    if row % 16 or row > _MAX_ROW_BYTES:
        raise ValueError(f"head_dim {D} of {q1.dtype} is not a multiple of "
                         f"16 bytes or wider than {_MAX_ROW_BYTES} bytes")
    for name, t in (("q", q1), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (s * t.element_size()) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs a unit stride on head_dim and "
                             f"16-byte aligned rows, got strides {t.stride()}")
    if T < 1:
        raise ValueError("empty KV cache")


def _per_row(x, B: int, device, sizes, what: str):
    """(tensor, element bytes, stride) of a per-row vector (or a scalar
    tensor) of one of ``sizes``' dtypes, as the kernel reads it in place."""
    if x.device != device:
        x = x.to(device)
    if x.dtype not in sizes:
        raise TypeError(f"{what} must be one of {sorted(map(str, sizes))}, "
                        f"got {x.dtype}")
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] not in (1, B)):
        raise ValueError(f"{what} must be a scalar or ({B},), got "
                         f"{tuple(x.shape)}")
    stride = x.stride(0) if x.dim() == 1 and x.shape[0] == B else 0
    return x, sizes[x.dtype], stride


def _meta(q, k, v):
    """A call on ``meta`` tensors: the output's shape and dtype, and the
    kernel's work by its bound's formula to the active
    ``repro_torch.analysis.opcount`` counter (raises outside one).  The
    lengths are unknown there: every slot is live over the whole view."""
    from repro_torch.analysis import opcount, roofline
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    nbytes, flops = roofline.ragged_decode_work(B, Hq, Hkv, D,
                                                q.element_size(), B * T)
    opcount.kernel("ragged_decode", flops, nbytes)
    return torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)


def ragged_decode_attention(q, k, v, lengths, *, window: int = 0,
                            logit_cap: float = 0.0, is_global=None,
                            live=None):
    """q: (B, 1, Hq, D); k, v: (B, T, Hkv, D), possibly a strided view of a
    longer cache (never copied); lengths: int or (B,) true KV lengths;
    live: optional (B,) bool -> (B, 1, Hq, D).  Dead rows return zeros."""
    global launches
    if q.device.type == "cpu":
        return ragged_decode_attention_ref(
            q, k, v, lengths, window=window, logit_cap=logit_cap,
            is_global=is_global, live=live)
    if q.device.type == "meta":
        return _meta(q, k, v)
    q1 = q[:, 0]
    _check(q1, k, v)
    B, Hq, D = q1.shape
    T, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if isinstance(lengths, numbers.Integral):
        len_ptr, len_size, len_stride = None, 0, 0
        len_value = max(1, min(int(lengths), T))
    else:
        lens, len_size, len_stride = _per_row(
            torch.as_tensor(lengths, device=dev), B, dev, _LEN_SIZES,
            "lengths")
        len_ptr, len_value = lens.data_ptr(), 0
    live_ptr, live_size, live_stride = None, 0, 0
    if live is not None:
        live_t, live_size, live_stride = _per_row(live, B, dev, _LIVE_SIZES,
                                                  "live")
        live_ptr = live_t.data_ptr()
    groups, gsize = head_groups(Hq // Hkv)
    chunk, n_split = split_plan(B, Hq, Hkv, T,
                                _build.sm_count(dev.index or 0))
    es = q.element_size()
    lanes = 1 << (D * es // 16 - 1).bit_length()   # power of two >= segments
    # one allocation: the output, then the fp32 partials (m, l) and acc.
    # split_plan counts the head groups, so B * Hkv * groups * n_split stays
    # near _BLOCKS_PER_SM blocks per SM and the partials near 4 * 8 * sms *
    # gsize * (2 + D) bytes whatever Hq (4.4 MB at D 128 on 132 SMs)
    out_bytes = -(-B * Hq * D * es // 256) * 256
    parts = B * Hq * n_split
    buf = torch.empty(out_bytes + 4 * parts * (2 + D), dtype=torch.uint8,
                      device=dev)
    base = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _ticket_buffer(dev, stream, ticket_count(B, Hq, Hkv))
    err = _fn()(q1.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, live_ptr,
                base + out_bytes, base + out_bytes + 8 * parts,
                tickets.data_ptr(), base,
                B, Hq, Hkv, D, T, chunk, n_split, lanes, groups, gsize,
                q1.stride(0), q1.stride(1),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                len_stride, len_size, len_value, live_stride, live_size,
                int(window), int(bool(is_global)), float(logit_cap),
                _DTYPES[q.dtype], stream)
    _build.check(err, "ragged_decode_attention")
    launches += 1
    return buf[:B * Hq * D * es].view(q.dtype).view(B, 1, Hq, D)
