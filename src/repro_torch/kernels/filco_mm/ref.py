"""Plain PyTorch versions of the filco_mm kernels.

Port of ``repro.kernels.filco_mm.ref``: the valid region is cut by masks,
not slices, so the same code serves any ``dims``.  Both A and B are masked
beyond ``k``: NaN or Inf in a buffer's padding never reaches the output.
"""
from __future__ import annotations

import torch


def flex_mm_ref(a_buf, b_buf, dims):
    """a_buf: (Mx, Kx); b_buf: (Kx, Nx); dims: int (3,) [m, k, n] ->
    (Mx, Nx) in a_buf's dtype: out[:m, :n] = a[:m, :k] @ b[:k, :n] with
    fp32 accumulation, zeros elsewhere."""
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
    out = torch.where((rows < m) & (cols < n), a @ b, zero)
    return out.to(a_buf.dtype)


def static_mm_ref(a_buf, b_buf):
    """The full padded product, fp32 accumulation, in a_buf's dtype."""
    return (a_buf.float() @ b_buf.float()).to(a_buf.dtype)
