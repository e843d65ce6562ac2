"""filco_mm — the runtime-flexible matmul and its static baseline: the CUDA
kernels' wrappers.

Replace the Pallas kernels of ``src/repro/kernels/filco_mm/kernel.py``:
``flex_mm`` (every CU pass of the data-plane simulator,
``core/simulator.py``) and ``static_mm`` (the padded CHARM-style baseline
of the single-kernel efficiency sweep).  The valid ``(m, k, n)`` of
``flex_mm`` are a device int32 operand read by the kernel, so one compiled
kernel serves every shape and a new shape costs 12 bytes in device memory,
with no host sync; csrc/filco_mm.cu has the design (fp32 as 3xTF32 on the
tensor cores, bf16 MMA).

``plan`` picks the kernel's tile and its reduction splits from the buffer
extents alone, never from the dims.  A launch with splits keeps its fp32
partial tiles in a workspace and its per-tile tickets in an int32 buffer,
both held per device and stream and grown on demand; every launch leaves
the tickets at zero.  ``flex_mm_3xtf32_ref`` in ``ref.py`` is the kernel's
fp32 arithmetic in plain PyTorch.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises; a ``meta`` tensor (the dry run) gives the output and
reports the kernel's work to ``repro_torch.analysis.opcount``.
``launches`` and ``static_launches`` count the calls
that launched a kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.filco_mm.ref import flex_mm_ref, static_mm_ref

launches = 0
static_launches = 0

# the kernel's compiled (bm, bn) output tiles, largest first
# (launch_tile in csrc/filco_mm.cu), and its staged reduction depth
TILES = ((128, 128), (128, 64), (64, 64), (32, 64), (16, 64), (16, 32),
         (16, 16))
TILE_K = 32
# blocks of each fp32 tile instance that one H100 SM holds at once, by the
# registers ptxas gives them and their shared tiles
_RESIDENT = {(128, 128): 2, (128, 64): 2, (64, 64): 3, (32, 64): 4,
             (16, 64): 5, (16, 32): 10, (16, 16): 14}
# a split reduction aims at this many blocks per SM, in splits of at least
# _MIN_STEPS k-steps and at most _MAX_SPLITS of them
_BLOCKS_PER_SM = 2.5
_MIN_STEPS = 3
_MAX_SPLITS = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def _flex_fn():
    fn = _build.load_library().filco_flex_mm
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I] * 5 + [_P, _P, _I,
                                                               _P]
    return fn


@functools.lru_cache(maxsize=1)
def _static_fn():
    fn = _build.load_library().filco_static_mm
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 3 + [_I] * 3 + [_L] * 3 + [_I] * 5 + [_P, _P, _I,
                                                               _P]
    return fn


def _ceil(x: int, a: int) -> int:
    return -(-x // a)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@functools.lru_cache(maxsize=4096)
def plan(Mx: int, Kx: int, Nx: int, sms: int = 132):
    """(bm, bn, bk, splits) for an (Mx, Kx) @ (Kx, Nx) buffer on a card of
    ``sms`` SMs.  Depends on the buffer extents only, never on the dims a
    call computes.

    Tiles no larger than the buffer's extents rounded up to a power of two
    are tried largest first.  If the largest gives ``sms`` blocks, it runs
    unsplit.  Else, where the reduction is deep enough, the first tile
    that reaches ``_BLOCKS_PER_SM`` blocks per SM with the fewest splits
    of at least ``_MIN_STEPS`` k-steps, all resident at once, is taken.
    Failing that, the fewest splits, then the largest tile, that give
    ``sms`` blocks; failing that, the smallest tile split into single
    k-steps.  Splits are whole ``bk`` steps of equal count, each
    non-empty: split s covers [s * kspan, (s + 1) * kspan) of Kx with
    ``kspan = split_span(Kx, bk, splits)``."""
    bk = TILE_K
    kt = max(1, _ceil(Kx, bk))
    fits = [(bm, bn) for bm, bn in TILES
            if bm <= max(16, _pow2(Mx)) and bn <= max(16, _pow2(Nx))]
    tiles = {t: max(1, _ceil(Mx, t[0]) * _ceil(Nx, t[1])) for t in fits}
    if tiles[fits[0]] >= sms:
        return (*fits[0], bk, 1)
    # split counts that cut the kt steps into equal non-empty spans
    counts = sorted({_ceil(kt, _ceil(kt, s)) for s in range(1, kt + 1)})
    cap = min(_MAX_SPLITS, kt // _MIN_STEPS)
    for t in fits:
        for s in counts:
            if s > cap or tiles[t] * s > _RESIDENT[t] * sms:
                break
            if s > 1 and tiles[t] * s >= _BLOCKS_PER_SM * sms:
                return (*t, bk, s)
    for s in counts:
        for t in fits:
            if tiles[t] * s >= sms:
                return (*t, bk, s)
    return (*fits[-1], bk, kt)


def split_span(Kx: int, bk: int, splits: int) -> int:
    """The reduction extent of one split: whole ``bk`` steps."""
    return bk * _ceil(max(1, _ceil(Kx, bk)), splits)


def grid(Mx: int, Nx: int, bm: int, bn: int, splits: int):
    """The launch grid (column tiles, row tiles, splits)."""
    return _ceil(Nx, bn), _ceil(Mx, bm), splits


# per (device, stream): the split launches' int32 tickets (zeros that every
# launch leaves at zero) and their fp32 partial-tile workspace
_scratch: dict = {}


def _split_scratch(device, stream: int, tiles: int, ws_elems: int):
    key = (device.index, stream)
    tickets, ws = _scratch.get(key, (None, None))
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                              device=device)
    if ws is None or ws.numel() < ws_elems:
        ws = torch.empty(max(ws_elems, 1 << 20), dtype=torch.float32,
                         device=device)
    _scratch[key] = (tickets, ws)
    return tickets, ws


def _vec_ok(t) -> bool:
    """Rows of ``t`` start 16-byte aligned (the kernel's 16-byte copies)."""
    return (t.stride(0) * t.element_size()) % 16 == 0 \
        and t.data_ptr() % 16 == 0


def _check(what, a, b, out, extra=()):
    """Shapes, dtypes, devices and strides the kernel takes; returns the
    output buffer (allocated when ``out`` is None).  Messages are built
    only on failure: the simulator calls this once per CU pass."""
    dev = a.device
    if not (dev.type == "cuda" and b.device == dev
            and all(t.device == dev for t in extra)):
        raise ValueError(
            f"{what}: every tensor must lie on one CUDA device, got "
            f"{[str(t.device) for t in (a, b) + tuple(extra)]}")
    if not (a.dtype in _DTYPES and b.dtype == a.dtype):
        raise TypeError(f"{what} takes float32 or bfloat16 a and b of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if not (a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0]):
        raise ValueError(f"{what}: a (Mx, Kx) and b (Kx, Nx) expected, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    Mx, Nx = a.shape[0], b.shape[1]
    if out is None:
        out = torch.empty((Mx, Nx), dtype=a.dtype, device=dev)
    if not (out.device == dev and out.dtype == a.dtype
            and out.shape == (Mx, Nx)):
        raise ValueError(f"{what}: out must be ({Mx}, {Nx}) {a.dtype} on "
                         f"{dev}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")
    if not all(t.stride(1) == 1 or t.shape[1] <= 1 for t in (a, b, out)):
        raise ValueError(f"{what} needs a unit stride on the last axis, got "
                         f"{a.stride()}, {b.stride()}, {out.stride()}")
    return out


def _launch(fn, head, a_buf, b_buf, out, what):
    """Plan, scratch and the C call shared by both kernels; ``head`` is the
    pointer arguments before the buffer extents."""
    Mx, Kx = a_buf.shape
    Nx = b_buf.shape[1]
    dev = a_buf.device
    bm, bn, bk, splits = plan(Mx, Kx, Nx, _build.sm_count(dev.index))
    kspan = split_span(Kx, bk, splits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = ws = None
    if splits > 1:
        gx, gy, _ = grid(Mx, Nx, bm, bn, splits)
        t, w = _split_scratch(dev, stream, gx * gy,
                              gx * gy * splits * bm * bn)
        tickets, ws = t.data_ptr(), w.data_ptr()
    vec = _vec_ok(a_buf) | _vec_ok(b_buf) << 1 | _vec_ok(out) << 2
    err = fn(*head, Mx, Kx, Nx, a_buf.stride(0), b_buf.stride(0),
             out.stride(0), vec, bm, bn, splits, kspan, ws, tickets,
             _DTYPES[a_buf.dtype], stream)
    _build.check(err, what)


def _meta(name, a_buf, b_buf, out):
    """A call on ``meta`` tensors: the output (``out`` or a new one) and
    the kernel's work to the active ``repro_torch.analysis.opcount``
    counter (raises outside one).  The valid dims are device data, unknown
    there: the whole buffer counts."""
    from repro_torch.analysis import opcount, roofline
    (Mx, Kx), Nx = a_buf.shape, b_buf.shape[1]
    if b_buf.shape[0] != Kx:
        raise ValueError(f"{name}: a (Mx, Kx) and b (Kx, Nx) expected, got "
                         f"{tuple(a_buf.shape)} and {tuple(b_buf.shape)}")
    nbytes, flops = roofline.mm_work(Mx, Kx, Nx, a_buf.element_size())
    opcount.kernel(name, flops, nbytes)
    if out is None:
        out = torch.empty((Mx, Nx), dtype=a_buf.dtype, device=a_buf.device)
    return out


def flex_mm(a_buf, b_buf, dims, *, out=None):
    """a_buf: (Mx, Kx); b_buf: (Kx, Nx); dims: int32 (3,) [m, k, n] on the
    same device -> (Mx, Nx) in a_buf's dtype: out[:m, :n] = a[:m, :k] @
    b[:k, :n] (fp32 accumulation), zeros elsewhere.  Strided windows (unit
    last stride) are taken as they are; ``out``, if given, is written in
    place and returned."""
    global launches
    if a_buf.device.type == "cpu":
        res = flex_mm_ref(a_buf, b_buf, dims)
        return res if out is None else out.copy_(res)
    if a_buf.device.type == "meta":
        return _meta("flex_mm", a_buf, b_buf, out)
    out = _check("flex_mm", a_buf, b_buf, out, (dims,))
    if not (dims.dtype == torch.int32 and dims.shape == (3,)
            and dims.stride(0) == 1):
        raise TypeError(f"flex_mm: dims must be a contiguous int32 (3,), "
                        f"got {dims.dtype} {tuple(dims.shape)}")
    _launch(_flex_fn(), (a_buf.data_ptr(), b_buf.data_ptr(), dims.data_ptr(),
                         out.data_ptr()), a_buf, b_buf, out, "flex_mm")
    launches += 1
    return out


def static_mm(a_buf, b_buf):
    """The full padded product a_buf @ b_buf (fp32 accumulation) in
    a_buf's dtype: the static baseline, every tile computed."""
    global static_launches
    if a_buf.device.type == "cpu":
        return static_mm_ref(a_buf, b_buf)
    if a_buf.device.type == "meta":
        return _meta("static_mm", a_buf, b_buf, None)
    out = _check("static_mm", a_buf, b_buf, None)
    _launch(_static_fn(), (a_buf.data_ptr(), b_buf.data_ptr(),
                           out.data_ptr()), a_buf, b_buf, out, "static_mm")
    static_launches += 1
    return out


def atoms_issued_flexible(m: int, k: int, n: int, *, buf=None, bm=None,
                          bk=None, bn=None, atom=None) -> int:
    """Atoms the flexible kernel issues for valid dims (m, k, n): live
    (bm, bk, bn) tiles only, ceil-padded per axis, each worth
    (bm / atom_m)(bk / atom_k)(bn / atom_n) atoms.  The tile defaults to
    the kernel's plan for the buffer ``buf`` (Mx, Kx, Nx), itself (m, k, n)
    by default as in the data-plane simulator, whose windows are the pass;
    splits do not change the count.  The atom defaults to the tile, one
    block's staged step; with the reference's tile and its MXU atom
    (8, 128, 128) the count is the reference's."""
    if bm is None or bk is None or bn is None:
        pm, pn, pk, _ = plan(*(buf or (m, k, n)))
        bm, bk, bn = bm or pm, bk or pk, bn or pn
    am, ak, an = atom or (bm, bk, bn)
    live_tiles = _ceil(m, bm) * _ceil(k, bk) * _ceil(n, bn)
    return live_tiles * (bm // am) * (bk // ak) * (bn // an)


def atoms_issued_static(Mx: int, Kx: int, Nx: int, *, bm=None, bk=None,
                        bn=None, atom=None) -> int:
    """Atoms the static baseline issues: the whole padded buffer, at the
    plan's tile for it by default."""
    return atoms_issued_flexible(Mx, Kx, Nx, bm=bm, bk=bk, bn=bn, atom=atom)
