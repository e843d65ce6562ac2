"""filco_mm — the runtime-flexible matmul and its static baseline: the CUDA
kernels' wrappers.

Replace the Pallas kernels of ``src/repro/kernels/filco_mm/kernel.py``:
``flex_mm`` (every CU pass of the data-plane simulator,
``core/simulator.py``) and ``static_mm`` (the padded CHARM-style baseline
of the single-kernel efficiency sweep).  The valid ``(m, k, n)`` of
``flex_mm`` are a device int32 operand read by the kernel, so one compiled
kernel serves every shape and a new shape costs 12 bytes in device memory,
with no host sync; csrc/filco_mm.cu has the design.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  ``launches`` and ``static_launches`` count the calls
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

# the CUDA kernel's block tile (kBM, kBK, kBN in csrc/filco_mm.cu): one
# block's staged (rows, reduction, columns) step is the port's atom
TILE_M, TILE_K, TILE_N = 128, 8, 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def _flex_fn():
    fn = _build.load_library().filco_flex_mm
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I, _I, _P]
    return fn


@functools.lru_cache(maxsize=1)
def _static_fn():
    fn = _build.load_library().filco_static_mm
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 3 + [_I] * 3 + [_L] * 3 + [_I, _I, _P]
    return fn


def _need(cond: bool, what: str, exc=ValueError) -> None:
    if not cond:
        raise exc(what)


def _vec_ok(t) -> bool:
    """Rows of ``t`` take aligned 4-element accesses."""
    return t.stride(0) % 4 == 0 and t.data_ptr() % (4 * t.element_size()) == 0


def _check(what, a, b, out, extra=()):
    """Shapes, dtypes, devices and strides the kernel takes; returns the
    output buffer (allocated when ``out`` is None)."""
    dev = a.device
    _need(dev.type == "cuda" and all(
        t.device == dev for t in (b,) + tuple(extra)),
        f"{what}: every tensor must lie on one CUDA device, got "
        f"{[str(t.device) for t in (a, b) + tuple(extra)]}")
    _need(a.dtype in _DTYPES and b.dtype == a.dtype,
          f"{what} takes float32 or bfloat16 a and b of one dtype, got "
          f"{a.dtype} and {b.dtype}", TypeError)
    _need(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
          f"{what}: a (Mx, Kx) and b (Kx, Nx) expected, got "
          f"{tuple(a.shape)} and {tuple(b.shape)}")
    Mx, Nx = a.shape[0], b.shape[1]
    if out is None:
        out = torch.empty((Mx, Nx), dtype=a.dtype, device=dev)
    _need(out.device == dev and out.dtype == a.dtype
          and tuple(out.shape) == (Mx, Nx),
          f"{what}: out must be ({Mx}, {Nx}) {a.dtype} on {dev}, got "
          f"{tuple(out.shape)} {out.dtype} on {out.device}")
    _need(all(t.stride(1) == 1 or t.shape[1] <= 1 for t in (a, b, out)),
          f"{what} needs a unit stride on the last axis, got "
          f"{a.stride()}, {b.stride()}, {out.stride()}")
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
    out = _check("flex_mm", a_buf, b_buf, out, (dims,))
    _need(dims.dtype == torch.int32 and dims.shape == (3,)
          and dims.stride(0) == 1,
          f"flex_mm: dims must be a contiguous int32 (3,), got "
          f"{dims.dtype} {tuple(dims.shape)}", TypeError)
    Mx, Kx = a_buf.shape
    Nx = b_buf.shape[1]
    vec = _vec_ok(a_buf) | _vec_ok(b_buf) << 1 | _vec_ok(out) << 2
    stream = torch.cuda.current_stream(a_buf.device).cuda_stream
    err = _flex_fn()(
        a_buf.data_ptr(), b_buf.data_ptr(), dims.data_ptr(), out.data_ptr(),
        Mx, Kx, Nx, a_buf.stride(0), b_buf.stride(0), out.stride(0), vec,
        _DTYPES[a_buf.dtype], stream)
    _build.check(err, "flex_mm")
    launches += 1
    return out


def static_mm(a_buf, b_buf):
    """The full padded product a_buf @ b_buf (fp32 accumulation) in
    a_buf's dtype: the static baseline, every tile computed."""
    global static_launches
    if a_buf.device.type == "cpu":
        return static_mm_ref(a_buf, b_buf)
    out = _check("static_mm", a_buf, b_buf, None)
    Mx, Kx = a_buf.shape
    Nx = b_buf.shape[1]
    vec = _vec_ok(a_buf) | _vec_ok(b_buf) << 1 | _vec_ok(out) << 2
    stream = torch.cuda.current_stream(a_buf.device).cuda_stream
    err = _static_fn()(
        a_buf.data_ptr(), b_buf.data_ptr(), out.data_ptr(), Mx, Kx, Nx,
        a_buf.stride(0), b_buf.stride(0), out.stride(0), vec,
        _DTYPES[a_buf.dtype], stream)
    _build.check(err, "static_mm")
    static_launches += 1
    return out


def atoms_issued_flexible(m: int, k: int, n: int, *, bm: int = TILE_M,
                          bk: int = TILE_K, bn: int = TILE_N,
                          atom=(TILE_M, TILE_K, TILE_N)) -> int:
    """Atoms the flexible kernel issues for valid dims (m, k, n): live
    (bm, bk, bn) tiles only, ceil-padded per axis, each worth
    (bm / atom_m)(bk / atom_k)(bn / atom_n) atoms.  The port's atom is the
    CUDA kernel's staged block step, so by default every live tile step is
    one atom; with the reference's tile and its MXU atom (8, 128, 128) the
    count is the reference's."""
    ceil = lambda x, a: -(-x // a)
    am, ak, an = atom
    live_tiles = ceil(m, bm) * ceil(k, bk) * ceil(n, bn)
    return live_tiles * (bm // am) * (bk // ak) * (bn // an)


def atoms_issued_static(Mx: int, Kx: int, Nx: int, *, bm: int = TILE_M,
                        bk: int = TILE_K, bn: int = TILE_N,
                        atom=(TILE_M, TILE_K, TILE_N)) -> int:
    """Atoms the static baseline issues: the whole padded buffer."""
    return atoms_issued_flexible(Mx, Kx, Nx, bm=bm, bk=bk, bn=bn, atom=atom)
