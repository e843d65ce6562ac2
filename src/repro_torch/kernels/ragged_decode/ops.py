"""Ragged decode attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/ragged_decode/kernel.py``
(``ragged_decode_kernel`` / ``_decode_kernel``), called on every decode step
from ``gqa_step``.  On the H100 the kernel is bound by the KV bytes of the
live rows: it reads each live row's KV prefix once per (slot, KV head),
shares it across that head's query group, stops at the row's true length
and skips dead slots, so the engine's bounded cache view costs no more
than its live prefix (csrc/ragged_decode.cu has the design).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_decode.ref import ragged_decode_attention_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_PAIRS = 8 * 128          # (head, word) outputs one block can hold
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.lru_cache(maxsize=1)
def _fn():
    fn = _build.load_library().ragged_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _F, _I, _P]
    return fn


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
    size = q1.element_size()
    if (D * size) % 16 or (Hq // Hkv) * (D * size // 4) > _MAX_PAIRS:
        raise ValueError(f"head_dim {D} of {q1.dtype} is not a multiple of "
                         f"16 bytes or too wide for one block")
    for name, t in (("q", q1), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (s * size) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs a unit stride on head_dim and "
                             f"16-byte aligned rows, got strides {t.stride()}")
    if T < 1:
        raise ValueError("empty KV cache")


def ragged_decode_attention(q, k, v, lengths, *, window: int = 0,
                            logit_cap: float = 0.0, is_global=None,
                            live=None):
    """q: (B, 1, Hq, D); k, v: (B, T, Hkv, D), possibly a strided view of a
    longer cache (never copied); lengths: (B,) true KV lengths; live:
    optional (B,) bool -> (B, 1, Hq, D).  Dead rows return zeros."""
    global launches
    if q.device.type == "cpu":
        return ragged_decode_attention_ref(
            q, k, v, lengths, window=window, logit_cap=logit_cap,
            is_global=is_global, live=live)
    q1 = q[:, 0]
    _check(q1, k, v)
    B, Hq, D = q1.shape
    T, Hkv = k.shape[1], k.shape[2]
    lens = torch.as_tensor(lengths, device=q.device).expand(B)
    lens = lens.clamp(1, T).to(torch.int32).contiguous()
    live_i = (torch.ones(B, dtype=torch.int32, device=q.device) if live is None
              else live.to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q1.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                live_i.data_ptr(), out.data_ptr(), B, Hq, Hkv, D,
                q1.stride(0), q1.stride(1),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                int(window), int(bool(is_global)), float(logit_cap),
                _DTYPES[q.dtype], stream)
    _build.check(err, "ragged_decode_attention")
    launches += 1
    return out[:, None]
