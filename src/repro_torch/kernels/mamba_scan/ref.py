"""Plain PyTorch versions of the two Mamba kernels.

``mamba_step_ref`` is the serving single-token chain of the reference's
``repro.models.ssm.mamba_step`` (and of its oracle
``repro.kernels.mamba_scan.ref.mamba_step_ref``) op for op, casts
included: xz, x_conv, (dt_raw, B, C), ``dt_raw @ dt_proj``, the gated y
and out are rounded to the activation dtype; the conv sum, softplus, the
recurrence and y are fp32.  It is functional: the kernel's wrapper and the
model copy its new state into the cache.

``skinny_product_spec`` is the order in which the bf16 step kernel sums
one weight product on the tensor cores, for the tests.

``mamba_scan_ref`` is the prefill selective scan: the function of the
reference's chunked ``selective_scan`` + C-projection in ``_ssm_inner``,
chunk by chunk with the state carried, each chunk stepped in time order
(the associative scan inside a chunk sums in another order only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_step_ref(x1, conv, h, in_proj, conv_w, conv_b, x_proj, dt_proj,
                   dt_bias, a_log, d, out_proj, *, live=None):
    """x1: (B, 1, d_model); conv: (B, w-1, d_in); h: (B, d_in, N) fp32 ->
    (out (B, 1, d_model), new_conv, new_h).  Rows with ``live`` false
    output zeros and carry their conv and h through unchanged."""
    f32 = torch.float32
    dt_rank, n = dt_proj.shape[0], a_log.shape[1]
    act = x1.dtype
    xz = x1 @ in_proj.to(act)
    x_part, z = xz.chunk(2, dim=-1)                       # (B, 1, d_in)
    window = torch.cat([conv.to(act), x_part], dim=1)     # (B, w, d_in)
    xc = torch.einsum("bwd,wd->bd", window.to(f32),
                      conv_w.to(f32)) + conv_b.to(f32)
    x_conv = F.silu(xc)[:, None].to(act)                  # (B, 1, d_in)
    dbc = x_conv @ x_proj.to(act)
    dt_raw, b_ssm, c_ssm = torch.split(dbc, [dt_rank, n, n], dim=-1)
    dt = softplus((dt_raw @ dt_proj.to(act)).to(f32)
                  + dt_bias.to(f32))[:, 0]                # (B, d_in)
    a = -torch.exp(a_log.to(f32))
    delta_a = torch.exp(dt[..., None] * a)                # (B, d_in, N)
    delta_bx = (dt * x_conv[:, 0].to(f32))[..., None] * \
        b_ssm[:, 0].to(f32)[:, None, :]
    h_new = delta_a * h + delta_bx
    y = torch.einsum("bdn,bn->bd", h_new, c_ssm[:, 0].to(f32))
    y = y + d.to(f32) * x_conv[:, 0].to(f32)
    y = (y * F.silu(z[:, 0].to(f32)))[:, None].to(act)
    out = y @ out_proj.to(act)
    new_conv = window[:, 1:].to(conv.dtype)
    if live is not None:
        lv = live.to(device=x1.device, dtype=torch.bool)[:, None, None]
        out = torch.where(lv, out, torch.zeros_like(out))
        new_conv = torch.where(lv, new_conv, conv)
        h_new = torch.where(lv, h_new, h)
    return out, new_conv, h_new


def skinny_product_spec(x, w, splits: int, span: int, *, stage: int = 128,
                        warps: int = 4, kstep: int = 16):
    """``x (B, K) @ w (K, N)`` in fp32 in the tensor-core step product's
    order: split s covers K rows [s span, (s + 1) span); in each ring stage
    of ``stage`` rows, warp i sums its k-steps of ``kstep`` rows (stage /
    kstep / warps of them, in order) into its own accumulator; a split's
    sum is its warps' accumulators added in warp order, and the splits are
    added in split order.  Products of two bf16 values are exact in fp32;
    within one k-step the tensor core's own order stands in for the
    ``@``'s."""
    f32 = torch.float32
    B, K = x.shape
    x32, w32 = x.to(f32), w.to(f32)
    per_warp = stage // kstep // warps
    total = torch.zeros((B, w.shape[1]), dtype=f32)
    for s in range(splits):
        kb, ke = s * span, min(K, (s + 1) * span)
        acc = [torch.zeros_like(total) for _ in range(warps)]
        for k0 in range(kb, ke, stage):
            for i in range(warps):
                for j in range(per_warp):
                    a = k0 + (i * per_warp + j) * kstep
                    b = min(a + kstep, ke)
                    if a < b:
                        acc[i] += x32[:, a:b] @ w32[a:b]
        part = acc[0]
        for i in range(1, warps):
            part = part + acc[i]
        total = total + part
    return total


def mamba_scan_ref(x, dt, b, c, a_log, d, *, chunk: int = 128):
    """x: (B, S, D); dt: (B, S, D) fp32 (already softplus'd); b, c: (B, S,
    N); a_log: (D, N); d: (D,) -> (y (B, S, D) fp32, h_last (B, D, N)
    fp32), from a zero state.  Any S."""
    f32 = torch.float32
    B, S, D = x.shape
    a = -torch.exp(a_log.to(f32))
    x32, dt32, b32, c32 = x.to(f32), dt.to(f32), b.to(f32), c.to(f32)
    h = torch.zeros((B, D, a.shape[1]), dtype=f32, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(S, s0 + chunk))
        delta_a = torch.exp(dt32[:, sl, :, None] * a)       # (B, c, D, N)
        delta_bx = (dt32[:, sl] * x32[:, sl])[..., None] * \
            b32[:, sl, None, :]
        hs = []
        for t in range(delta_a.shape[1]):
            h = delta_a[:, t] * h + delta_bx[:, t]
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1),
                               c32[:, sl]))
    y = torch.cat(ys, dim=1) + d.to(f32) * x32
    return y, h
