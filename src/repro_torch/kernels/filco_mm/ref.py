"""Plain PyTorch versions of the filco_mm kernels.

Port of ``repro.kernels.filco_mm.ref``: the valid region is cut by masks,
not slices, so the same code serves any ``dims``.  Both A and B are masked
beyond ``k``: NaN or Inf in a buffer's padding never reaches the output.
"""
from __future__ import annotations

import torch


def _masked(a_buf, b_buf, dims):
    """fp32 copies of the operands with zeros outside [:m, :k] and
    [:k, :n], the output's valid mask [:m, :n], and an fp32 zero."""
    Mx, Kx = a_buf.shape
    Nx = b_buf.shape[1]
    dev = a_buf.device
    m, k, n = (torch.as_tensor(dims, device=dev)[i] for i in range(3))
    rows = torch.arange(Mx, device=dev)[:, None]
    red_r = torch.arange(Kx, device=dev)[:, None]
    red_c = torch.arange(Kx, device=dev)[None, :]
    cols = torch.arange(Nx, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    a = torch.where((rows < m) & (red_c < k), a_buf.float(), zero)
    b = torch.where((red_r < k) & (cols < n), b_buf.float(), zero)
    return a, b, (rows < m) & (cols < n), zero


def flex_mm_ref(a_buf, b_buf, dims):
    """a_buf: (Mx, Kx); b_buf: (Kx, Nx); dims: int (3,) [m, k, n] ->
    (Mx, Nx) in a_buf's dtype: out[:m, :n] = a[:m, :k] @ b[:k, :n] with
    fp32 accumulation, zeros elsewhere."""
    a, b, valid, zero = _masked(a_buf, b_buf, dims)
    return torch.where(valid, a @ b, zero).to(a_buf.dtype)


def static_mm_ref(a_buf, b_buf):
    """The full padded product, fp32 accumulation, in a_buf's dtype."""
    return (a_buf.float() @ b_buf.float()).to(a_buf.dtype)


def tf32_round(x):
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the 13 dropped bits of the
    magnitude rounded by an integer add and mask, as the kernel does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def flex_mm_3xtf32_ref(a_buf, b_buf, dims, *, bk: int = 32,
                       splits: int = 1):
    """The CUDA kernel's fp32 arithmetic, in plain PyTorch: the masked
    operands split into a TF32 head and the TF32 rounding of the rest,
    head.head + head.tail + tail.head over each split's span of the
    reduction, the splits summed in split order.  Split s covers
    [s * kspan, (s + 1) * kspan) with kspan whole ``bk`` steps
    (``ops.split_span``).  Returns fp32 (Mx, Nx), zeros outside
    [:m, :n]."""
    a, b, valid, zero = _masked(a_buf, b_buf, dims)
    Mx, Kx = a.shape
    a_h, b_h = tf32_round(a), tf32_round(b)
    a_t, b_t = tf32_round(a - a_h), tf32_round(b - b_h)
    kt = max(1, -(-Kx // bk))
    kspan = bk * -(-kt // splits)
    out = torch.zeros((Mx, b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for s in range(splits):
        ks = slice(s * kspan, (s + 1) * kspan)
        out = out + (a_t[:, ks] @ b_h[ks] + a_h[:, ks] @ b_t[ks]
                     + a_h[:, ks] @ b_h[ks])
    return torch.where(valid, out, zero)
