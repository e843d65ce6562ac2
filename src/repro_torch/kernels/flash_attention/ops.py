"""Flash attention: the CUDA kernel's wrapper.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention`` / ``_flash_kernel``) and covers the contract of the
reference's ``layers.blockwise_attention`` that ``gqa_prefill``, the
encoders' ``gqa_fwd`` and training's ``cross_fwd`` run: GQA by head index,
causal or bidirectional, sliding window with a global-layer bypass, logit
soft-cap, lengths that are not a multiple of the tile, per-row key padding
(``kv_len``: key ``j`` of row ``b`` counts only where ``j < kv_len[b]``;
each row's key loop ends at its last valid tile), and keys of another
length than the queries (k, v (B, Skv, Hkv, D): cross-attention over an
encoder output) where the mask is bidirectional without a window or key
padding; causal or windowed calls with Skv != S raise, as the reference
asks for neither without a ``q_offset``, which the kernels do not take.
On the H100 the kernel is bound by operations.  bf16 runs on the tensor
cores (mma.sync, K and V staged by cp.async, the softmax in registers);
fp32 keeps a CUDA-core kernel, since TF32 would change its numerics.  Both
skip the key tiles above the diagonal or outside the window
(csrc/flash_attention.cu has the design).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises; a ``meta`` tensor (the dry run) gives the outputs'
shapes and reports the kernel's work to ``repro_torch.analysis.opcount``,
by the formula of its bound.  Each launch adds one to one counter:
``masked_launches`` with key padding, else by the head dim's kernel
instance, ``launches`` up to 128, ``d192_launches`` above 128 up to 192
and ``d256_launches`` above that.  ``grid`` gives the blocks one call
launches.

Training: where autograd records the call (grad mode on and q, k or v
requiring grad), a CUDA call runs ``FlashAttentionFn``.  Its forward
launches the same kernel with the log-sum-exp output, its backward the
backward kernels (csrc/flash_attention_bwd.cu), which take causal or
bidirectional GQA, Skv apart from S where bidirectional, and a sliding
window with the global-layer bypass (hymba), and raise on a logit cap,
key padding and head dims above 192, each naming the ROADMAP item that
lifts it.  Each call counts once, by its mask (``_train_kind``): with a
sliding window ``lse_window_launches`` / ``bwd_window_launches``, else
above head dim 128 (to 192: MLA's q/k head dim) ``lse_d192_launches`` /
``bwd_d192_launches``, else with Skv != S (cross-attention)
``lse_cross_launches`` / ``bwd_cross_launches``, else bidirectional
``lse_bidir_launches`` / ``bwd_bidir_launches``, else causal
``lse_launches`` / ``bwd_launches``.  bf16 runs on the tensor cores
(four warps a block up to 128, eight at 192), fp32 on the CUDA cores.
``bwd_plan`` splits a KV head's query heads over ``n_split`` dK/dV
blocks where the (batch, KV head, key tile) blocks alone would leave
the card half idle; the splits' fp32 partials are folded in split order
by a third launch, so the result stays bitwise repeatable.
``flash_attention_bwd_split_ref`` in ``ref.py`` is that fold in plain
PyTorch.  On a CPU tensor the plain version carries its own gradient
(``layers.blockwise_attention``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)

launches = 0
masked_launches = 0
d192_launches = 0
d256_launches = 0
lse_launches = 0
lse_d192_launches = 0
lse_window_launches = 0
lse_bidir_launches = 0
lse_cross_launches = 0
bwd_launches = 0
bwd_d192_launches = 0
bwd_window_launches = 0
bwd_bidir_launches = 0
bwd_cross_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_ROW_BYTES = 16               # a row is a whole number of 16-byte chunks
_BQ = 64                      # query rows per block, both kernels
_MAX_BWD_D = 192
_BWD_NARROW_D = 128           # above it the backward's 8-warp instances
# dK/dV blocks per SM that bwd_plan aims at: two 4-warp blocks fit an SM
# up to head dim 128, one 8-warp block at 192 (175 KB of shared memory)
_BWD_BLOCKS_PER_SM = 2
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.lru_cache(maxsize=1)
def _fn():
    fn = _build.load_library().flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _I, _I, _F, _P, _F, _I, _P]
    return fn


@functools.lru_cache(maxsize=1)
def _lse_fn():
    fn = _build.load_library().flash_attention_lse
    fn.restype = ctypes.c_int
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _I, _I, _F, _I, _P]
    return fn


@functools.lru_cache(maxsize=1)
def _bwd_fn():
    fn = _build.load_library().flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 11 + [_I] * 11 + [_P]
    return fn


def head_dim_supported(D: int, dtype) -> bool:
    """Whether the kernel takes head dim ``D`` of ``dtype``: up to
    ``_MAX_D``, rows of whole 16-byte chunks."""
    size = torch.empty((), dtype=dtype).element_size()
    return 0 < D <= _MAX_D and (D * size) % _ROW_BYTES == 0


def _check_shapes(q, k, v, kv_len, window, is_global, causal):
    """Raise on the shapes, masks and dtypes the kernel does not take."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if Skv != S and (causal or _windowed(window, is_global)
                     or kv_len is not None):
        raise ValueError(
            f"{Skv} keys for {S} queries: the kernel takes Skv != S only "
            f"bidirectional without a sliding window or key padding (a "
            f"causal or windowed mask would need a q_offset)")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not head_dim_supported(D, q.dtype):
        raise ValueError(f"head_dim {D} of {q.dtype}: the kernel takes up to "
                         f"{_MAX_D}, a multiple of {_ROW_BYTES} bytes")
    if kv_len is not None and window and not is_global:
        # a query row past its length may then see no key at all
        raise ValueError("kv_len with a sliding window is not supported by "
                         "the kernel")


def _check(q, k, v, kv_len, window, is_global, causal):
    """Raise on what the kernel does not take."""
    _check_shapes(q, k, v, kv_len, window, is_global, causal)
    B = q.shape[0]
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("q, k and v must lie on one CUDA device")
    size = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (s * size) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs a unit stride on head_dim and "
                             f"16-byte aligned rows, got strides {t.stride()}")
    if kv_len is not None:
        if (kv_len.device != q.device or kv_len.dtype != torch.int32
                or tuple(kv_len.shape) != (B,) or not kv_len.is_contiguous()):
            raise ValueError(f"kv_len must be a contiguous ({B},) int32 "
                             f"tensor on {q.device}, got {kv_len.dtype} "
                             f"{tuple(kv_len.shape)} on {kv_len.device}")


def grid(B: int, S: int, Hq: int):
    """Blocks of one launch: one per (batch * head, 64-query tile)."""
    return B * Hq * -(-S // _BQ)


def empty_row_divisor(S: int, block_size: int = 512) -> float:
    """What the plain version divides a length-0 row's sum of V by: it
    scores every key of its padded blocks alike, ``ceil(S / bs) * bs``
    keys with ``bs = min(block_size, S)``."""
    bs = min(block_size, S)
    return float(-(-S // bs) * bs)


def _meta(name, q, k, v, *, causal, window, is_global, kv_len=None,
          lse: bool = False):
    """A call on ``meta`` tensors: the kernel's outputs (shapes and dtypes
    only) and its work, by its bound's formula, to the active
    ``repro_torch.analysis.opcount`` counter; raises outside one.  Key
    padding is unknown on meta tensors: every key counts."""
    from repro_torch.analysis import opcount, roofline
    _check_shapes(q, k, v, kv_len, window, is_global, causal)
    B, S, Hq, D = q.shape
    pairs = roofline.flash_pairs(B, S, k.shape[1], Hq, causal, window,
                                 is_global)
    nbytes, flops = roofline.flash_work(q.numel(), k.numel() + v.numel(), D,
                                        pairs, q.element_size(),
                                        B * S * Hq if lse else 0)
    opcount.kernel(name, flops, nbytes)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if not lse:
        return out
    return out, torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, is_global=None, kv_len=None):
    """q: (B, S, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, S, Hq, D), Skv = S
    where causal, windowed or key-padded.  kv_len: optional (B,) int32
    valid keys per row, on q's device."""
    global launches, masked_launches, d192_launches, d256_launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, is_global=is_global,
                                   kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_bwd(q, logit_cap, kv_len)
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                      is_global)
    if q.device.type == "meta":
        D = q.shape[-1]
        name = ("flash_attention_kv_len" if kv_len is not None
                else "flash_attention_d256" if D > 192
                else "flash_attention_d192" if D > 128
                else "flash_attention")
        return _meta(name, q, k, v, causal=causal, window=window,
                     is_global=is_global, kv_len=kv_len)
    _check(q, k, v, kv_len, window, is_global, causal)
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, Skv, Hq, k.shape[2], D,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                out.stride(0), out.stride(1), out.stride(2),
                int(bool(causal)), int(window), int(bool(is_global)),
                float(logit_cap),
                None if kv_len is None else kv_len.data_ptr(),
                empty_row_divisor(S), _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention")
    if kv_len is not None:
        masked_launches += 1
    elif D > 192:
        d256_launches += 1
    elif D > 128:
        d192_launches += 1
    else:
        launches += 1
    return out


# ---------------------------------------------------------------------------
# training: the forward with its log-sum-exp, and the backward kernel
# ---------------------------------------------------------------------------

def _check_bwd(q, logit_cap, kv_len):
    """Raise on what the backward kernel does not take, naming the ROADMAP
    item that brings it (a sliding window it takes)."""
    D = q.shape[-1]
    if logit_cap > 0.0:
        raise NotImplementedError(
            "flash backward: a logit cap is not supported by the kernel "
            "(ROADMAP queue 2 (a); no registered arch trains with one)")
    if kv_len is not None:
        raise NotImplementedError(
            "flash backward: key padding (kv_len) is not supported by the "
            "kernel (ROADMAP queue 2 (a)); no reference training path pads "
            "keys: enc-dec training attends exact-length encoder outputs")
    if D > _MAX_BWD_D:
        raise NotImplementedError(
            f"flash backward: head_dim {D} > {_MAX_BWD_D} is not supported "
            "by the kernel (ROADMAP queue 2 (a))")


def _windowed(window, is_global) -> bool:
    """Whether the mask has a sliding window: one given, and the layer not
    global."""
    return bool(window) and not bool(is_global)


def _train_kind(q, k, causal, window, is_global) -> str:
    """The suffix of the training counters a call adds to (see the top):
    "_window", "_d192", "_cross", "_bidir" or ""."""
    if _windowed(window, is_global):
        return "_window"
    if q.shape[-1] > _BWD_NARROW_D:
        return "_d192"
    if k.shape[1] != q.shape[1]:
        return "_cross"
    return "" if causal else "_bidir"


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        is_global=None):
    """q: (B, S, Hq, D); k, v: (B, Skv, Hkv, D) -> (out (B, S, Hq, D), lse
    (B, S, Hq) fp32): the flash kernel with its log-sum-exp output, natural
    units of the scaled scores; ``window`` and Skv as ``flash_attention``
    takes them.  A CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                       is_global=is_global)
    if q.device.type == "meta":
        return _meta("flash_attention_lse"
                     + _train_kind(q, k, causal, window, is_global), q, k, v,
                     causal=causal, window=window, is_global=is_global,
                     lse=True)
    _check(q, k, v, None, window, is_global, causal)
    B, S, Hq, D = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lse_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), B, S, k.shape[1], Hq, k.shape[2], D,
                    q.stride(0), q.stride(1), q.stride(2),
                    k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    out.stride(0), out.stride(1), out.stride(2),
                    int(bool(causal)), int(window), int(bool(is_global)),
                    0.0, _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_lse")
    globals()["lse" + _train_kind(q, k, causal, window, is_global)
              + "_launches"] += 1
    return out, lse


def bwd_plan(B: int, Skv: int, Hq: int, Hkv: int, sms: int,
             D: int = 128) -> int:
    """The backward's ``n_split``: the least divisor of G = Hq / Hkv that
    gives the dK/dV launch, ``B * Hkv * ceil(Skv / 64) * n_split`` blocks
    (Skv: the key length), at least as many blocks per SM as fit one
    (``_BWD_BLOCKS_PER_SM`` up to head dim 128, one above) on a card of
    ``sms`` SMs, or G where none does.  Host ints only."""
    G = Hq // Hkv
    blocks = B * Hkv * -(-Skv // _BQ)
    if blocks == 0:
        return 1
    per_sm = _BWD_BLOCKS_PER_SM if D <= _BWD_NARROW_D else 1
    return next((n for n in range(1, G + 1) if G % n == 0
                 and blocks * n >= per_sm * sms), G)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0, is_global=None):
    """Gradients (dq, dk, dv) of the flash attention whose forward gave
    ``out`` and ``lse``, for the output gradient ``dout``; the dQ kernel
    also computes ``delta = rowsum(dout * out)`` in fp32, for the dK/dV
    kernel.  ``window``: the sliding window, bypassed where ``is_global``;
    k and v of Skv keys as the forward takes them.  A CPU tensor takes the
    plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       causal=causal, window=window,
                                       is_global=is_global)
    if q.device.type == "meta":
        return _meta_bwd(q, k, v, causal=causal, window=window,
                         is_global=is_global)
    _check(q, k, v, None, window, is_global, causal)
    _check_bwd(q, 0.0, None)
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, dout, out = (t.contiguous() for t in (
        q, k, v, dout.to(q.dtype), out.to(q.dtype)))
    lse = lse.contiguous()
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, S, Hq):
        raise ValueError(f"lse must be ({B}, {S}, {Hq}) float32, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_split = bwd_plan(B, Skv, Hq, Hkv,
                       _build.sm_count(q.device.index or 0), D)
    partial = (torch.empty((2, n_split, B, Skv, Hkv, D), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    B, S, Skv, Hq, Hkv, D, int(bool(causal)), int(window),
                    int(bool(is_global)), n_split, _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention_bwd")
    globals()["bwd" + _train_kind(q, k, causal, window, is_global)
              + "_launches"] += 1
    return dq, dk, dv


def _meta_bwd(q, k, v, *, causal, window, is_global):
    """``flash_attention_bwd`` on ``meta`` tensors: (dq, dk, dv) of q's,
    k's and v's shapes and its work to the active counter (see ``_meta``)."""
    from repro_torch.analysis import opcount, roofline
    _check_shapes(q, k, v, None, window, is_global, causal)
    _check_bwd(q, 0.0, None)
    B, S, Hq, D = q.shape
    pairs = roofline.flash_pairs(B, S, k.shape[1], Hq, causal, window,
                                 is_global)
    nbytes, flops = roofline.flash_bwd_work(
        q.numel(), k.numel() + v.numel(), D, pairs, q.element_size(),
        B * S * Hq)
    opcount.kernel("flash_attention_bwd"
                   + _train_kind(q, k, causal, window, is_global),
                   flops, nbytes)
    return tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device)
                 for t in (q, k, v))


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient on the card: the forward kernel
    with its log-sum-exp, then the backward kernel, under the same mask
    (causal, sliding window, global bypass); saves (q, k, v, out, lse) as
    the reference's ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0, is_global=None):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window,
                                       is_global=is_global)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, is_global=is_global)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.mask)
        return dq, dk, dv, None, None, None
