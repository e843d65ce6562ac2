"""Plain PyTorch versions of the two Mamba kernels.

``mamba_step_ref`` is the serving single-token chain of the reference's
``repro.models.ssm.mamba_step`` (and of its oracle
``repro.kernels.mamba_scan.ref.mamba_step_ref``) op for op, casts
included: xz, x_conv, (dt_raw, B, C), ``dt_raw @ dt_proj``, the gated y
and out are rounded to the activation dtype; the conv sum, softplus, the
recurrence and y are fp32.  It is functional: the kernel's wrapper and the
model copy its new state into the cache.

``mamba_step_staged_ref`` is the same step on one rank's channels of a
tensor-parallel group, split at its two sums over the channels (x_proj's
and out_proj's), which a caller's ``reduce`` completes in fp32; the CUDA
step's staged entry computes it on the card.

``skinny_product_spec`` is the order in which the bf16 step kernel sums
one weight product on the tensor cores, for the tests.

``mamba_scan_ref`` is the prefill selective scan: the function of the
reference's chunked ``selective_scan`` + C-projection in ``_ssm_inner``,
chunk by chunk with the state carried, each chunk stepped in time order
(the associative scan inside a chunk sums in another order only).
``mamba_scan_spec`` is the same function in the CUDA scan's order of
arithmetic, for the tests.

``selective_scan_fwd_ref`` and ``selective_scan_bwd_ref`` are the training
pair, the reference's ``fused_selective_scan`` custom VJP
(``repro.models.ssm._fss_fwd`` / ``_fss_bwd``): the forward's y with the
state at the start of every ``chunk`` steps (the only residual besides the
inputs), and the backward that recomputes each chunk's states from its
boundary, then sweeps it in reverse for (dx, ddt, dB, dC, dA, dD).
``selective_scan_bwd_split_ref`` is that backward in the CUDA kernel's
order (sub-chunks recomputed from their starts; dB and dC folded by
block, cluster, then cluster partials), for the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LOG2E = 1.4426950408889634
# steps between the boundary states the training forward saves (the CUDA
# backward's kBwdChunk: one chunk's states fit a block's shared memory)
SCAN_CHUNK = 32


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


def mamba_step_a_ref(x1, conv, in_proj, conv_w, conv_b, x_proj):
    """The step's first stage on a rank's channels: in_proj, the conv and
    x_proj, whose output is a sum over the channels.  x1: (B, 1, d_model);
    conv: (B, w-1, d_in) -> (dbc (B, R + 2N) fp32, the x_proj product
    over these channels, unrounded; x_conv and z (B, d_in) in x1's dtype;
    new_conv).  ``mamba_step_ref``'s arithmetic up to x_proj."""
    f32 = torch.float32
    act = x1.dtype
    xz = x1 @ in_proj.to(act)
    x_part, z = xz.chunk(2, dim=-1)
    window = torch.cat([conv.to(act), x_part], dim=1)
    xc = torch.einsum("bwd,wd->bd", window.to(f32),
                      conv_w.to(f32)) + conv_b.to(f32)
    x_conv = F.silu(xc).to(act)                           # (B, d_in)
    dbc = x_conv.to(f32) @ x_proj.to(act).to(f32)
    return dbc, x_conv, z[:, 0], window[:, 1:].to(conv.dtype)


def mamba_step_b_ref(dbc, x_conv, z, h, dt_proj, dt_bias, a_log, d,
                     out_proj):
    """The second stage from the x_proj sum over every channel, ``dbc``
    (B, R + 2N) fp32: dbc rounded to the activation dtype, dt_proj, the
    state update and out_proj, whose output is again a sum over the
    channels -> (out (B, d_model) fp32, unrounded; new_h)."""
    f32 = torch.float32
    act = x_conv.dtype
    dt_rank, n = dt_proj.shape[0], a_log.shape[1]
    dt_raw, b_ssm, c_ssm = torch.split(dbc.to(act), [dt_rank, n, n], dim=-1)
    dt = softplus((dt_raw @ dt_proj.to(act)).to(f32) + dt_bias.to(f32))
    a = -torch.exp(a_log.to(f32))
    delta_a = torch.exp(dt[..., None] * a)                # (B, d_in, N)
    delta_bx = (dt * x_conv.to(f32))[..., None] * b_ssm.to(f32)[:, None, :]
    h_new = delta_a * h + delta_bx
    y = torch.einsum("bdn,bn->bd", h_new, c_ssm.to(f32))
    y = y + d.to(f32) * x_conv.to(f32)
    y = (y * F.silu(z.to(f32))).to(act)
    return y.to(f32) @ out_proj.to(act).to(f32), h_new


def mamba_step_staged_ref(x1, conv, h, in_proj, conv_w, conv_b, x_proj,
                          dt_proj, dt_bias, a_log, d, out_proj, *,
                          live=None, reduce=None):
    """``mamba_step_ref`` on one rank's channels of a tensor-parallel
    group, split at its two sums over the channels: ``reduce(t)`` sums the
    fp32 x_proj output, then the fp32 out_proj output, over the group in
    place (None: this rank holds every channel).  The out_proj sum is
    rounded to x1's dtype once, after the second sum.  Same arguments and
    results as ``mamba_step_ref``."""
    dbc, x_conv, z, new_conv = mamba_step_a_ref(x1, conv, in_proj, conv_w,
                                                conv_b, x_proj)
    if reduce is not None:
        reduce(dbc)
    out, h_new = mamba_step_b_ref(dbc, x_conv, z, h, dt_proj, dt_bias,
                                  a_log, d, out_proj)
    if reduce is not None:
        reduce(out)
    out = out.to(x1.dtype)[:, None]
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


def _fma(a, b, c):
    """fp32 ``a b + c`` rounded once (the product is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def mamba_scan_spec(x, dt, b, c, a_log, d, *, states_per_lane: int = 4):
    """The prefill scan in fp32 in the CUDA kernel's order of arithmetic:
    a channel's N states lie on G = N / K lanes, K = min(states_per_lane,
    N) (the kernel holds 4), lane g holding states [g K, (g + 1) K).  Per
    step and state, h = fma(2^(dt (A log2 e)), h, (dt x) B), with A log2 e
    and both products rounded to fp32; lane g's partial of y is an fma
    chain over its states in order, starting from D x on lane 0 and from
    0 on the others; the G partials are summed by xor offsets G / 2, ...,
    1.  2^ is taken here to within an ulp where the kernel takes MUFU.EX2
    (within a few).  Same arguments and results as ``mamba_scan_ref``."""
    f32 = torch.float32
    B, S, D = x.shape
    N = b.shape[-1]
    K = min(states_per_lane, N)
    G = N // K
    a2 = -torch.exp(a_log.to(f32)) * torch.tensor(LOG2E, dtype=f32)
    x32, dt32, b32, c32 = (v.to(f32) for v in (x, dt, b, c))
    h = torch.zeros((B, D, N), dtype=f32, device=x.device)
    y = torch.empty((B, S, D), dtype=f32, device=x.device)
    lane0 = torch.zeros((G,), dtype=f32, device=x.device)
    lane0[0] = 1.0
    for t in range(S):
        dtt, xt = dt32[:, t], x32[:, t]                    # (B, D)
        da = torch.exp2(dtt[..., None] * a2)               # (B, D, N)
        h = _fma(da, h, (dtt * xt)[..., None] * b32[:, t, None, :])
        hk = h.view(B, D, G, K)
        ck = c32[:, t].view(B, 1, G, K).expand(B, D, G, K)
        part = (d.to(f32) * xt)[..., None] * lane0          # (B, D, G)
        for k in range(K):
            part = _fma(hk[..., k], ck[..., k], part)
        o = G // 2
        while o:
            part = part + part[..., torch.arange(G) ^ o]
            o //= 2
        y[:, t] = part[..., 0]
    return y, h


def selective_scan_fwd_ref(x, dt, b, c, a_log, d, *, chunk: int = SCAN_CHUNK):
    """The training forward: ``mamba_scan_ref``'s y, and the state at the
    start of each chunk of ``chunk`` steps, ``bounds`` (nchunk, B, D, N)
    fp32 (``bounds[0]`` the zero state), as the reference's ``_fss_fwd``
    saves them.  Any S: the last chunk may be short."""
    f32 = torch.float32
    B, S, D = x.shape
    a = -torch.exp(a_log.to(f32))
    x32, dt32, b32, c32 = x.to(f32), dt.to(f32), b.to(f32), c.to(f32)
    h = torch.zeros((B, D, a.shape[1]), dtype=f32, device=x.device)
    ys, bounds = [], []
    for s0 in range(0, S, chunk):
        bounds.append(h)
        sl = slice(s0, min(S, s0 + chunk))
        delta_a = torch.exp(dt32[:, sl, :, None] * a)
        delta_bx = (dt32[:, sl] * x32[:, sl])[..., None] * \
            b32[:, sl, None, :]
        hs = []
        for t in range(delta_a.shape[1]):
            h = delta_a[:, t] * h + delta_bx[:, t]
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1),
                               c32[:, sl]))
    y = torch.cat(ys, dim=1) + d.to(f32) * x32
    return y, torch.stack(bounds)


def selective_scan_bwd_ref(x, dt, b, c, a_log, d, bounds, gy, *,
                           chunk: int = SCAN_CHUNK):
    """The gradients of ``selective_scan_fwd_ref``'s y for the output
    gradient ``gy`` (B, S, D), from its ``bounds``: (dx, ddt, dB, dC, dA,
    dD), dA with respect to A = -exp(A_log), as the reference's
    ``_fss_bwd`` gives them.  Chunk by chunk in reverse, each chunk's
    states are recomputed from its boundary, then the reverse scan g_t =
    gy_t C_t + a_{t+1} g_{t+1} (g = dL/dh_t, a_t = exp(dt_t A)) runs
    through it, the carry a g passing into the chunk before.  Sums in
    fp32; dx, dB and dC come back in the dtypes of x, b and c, the rest
    in fp32."""
    f32 = torch.float32
    B, S, D = x.shape
    N = b.shape[-1]
    a = -torch.exp(a_log.to(f32))
    x32, dt32, b32, c32, gy32 = (t.to(f32) for t in (x, dt, b, c, gy))
    dx = torch.empty((B, S, D), dtype=f32, device=x.device)
    ddt = torch.empty_like(dx)
    db = torch.empty((B, S, N), dtype=f32, device=x.device)
    dc = torch.empty_like(db)
    da_sum = torch.zeros((D, N), dtype=f32, device=x.device)
    g = torch.zeros((B, D, N), dtype=f32, device=x.device)
    for k in reversed(range(bounds.shape[0])):
        sl = slice(k * chunk, min(S, (k + 1) * chunk))
        dtk, xk, bk, ck, gk = (t[:, sl] for t in (dt32, x32, b32, c32, gy32))
        delta_a = torch.exp(dtk[..., None] * a)             # (B, c, D, N)
        delta_bx = (dtk * xk)[..., None] * bk[:, :, None, :]
        h = bounds[k].to(f32)
        h_prev = []
        for t in range(delta_a.shape[1]):
            h_prev.append(h)
            h = delta_a[:, t] * h + delta_bx[:, t]
        h_prev = torch.stack(h_prev, dim=1)                 # h_{t-1}
        h_all = torch.cat([h_prev[:, 1:], h[:, None]], dim=1)
        gs = [None] * delta_a.shape[1]
        for t in reversed(range(delta_a.shape[1])):
            g = gk[:, t, :, None] * ck[:, t, None, :] + g
            gs[t] = g
            g = delta_a[:, t] * g
        gt = torch.stack(gs, dim=1)                         # (B, c, D, N)
        dda = gt * h_prev
        gb = torch.sum(gt * bk[:, :, None, :], dim=-1)
        ddt[:, sl] = torch.sum(dda * (a * delta_a), dim=-1) + gb * xk
        dx[:, sl] = gb * dtk + d.to(f32) * gk
        db[:, sl] = torch.sum(gt * (dtk * xk)[..., None], dim=2)
        dc[:, sl] = torch.einsum("bsd,bsdn->bsn", gk, h_all)
        da_sum = da_sum + torch.sum(dda * dtk[..., None] * delta_a,
                                    dim=(0, 1))
    dd = torch.sum(gy32 * x32, dim=(0, 1))
    return (dx.to(x.dtype), ddt, db.to(b.dtype), dc.to(c.dtype), da_sum, dd)


def selective_scan_bwd_split_ref(x, dt, b, c, a_log, d, bounds, gy, *,
                                 channels: int, cluster: int, sub: int = 8,
                                 chunk: int = SCAN_CHUNK):
    """``selective_scan_bwd_ref`` in the CUDA backward's order, for the
    tests (``ops.scan_bwd_plan`` gives ``channels`` and ``cluster``).
    Each chunk's states come from its boundary one ``sub``-step
    sub-chunk at a time: a first pass keeps the state that starts each
    sub-chunk, then each sub-chunk, the last first, is recomputed (h_{t-1}
    and a_t = 2^(dt (A log2 e)), as the kernel takes it) and swept back.
    dB and dC at (b, t) are summed in fp32 over each block's ``channels``
    channels, over the blocks of a cluster of ``cluster`` in rank order,
    then over the clusters in order (the fold launch); channels past D,
    up to whole clusters, count as zeros.  dA and dD are summed per row,
    then over the rows in order.  Same arguments and results."""
    f32 = torch.float32
    B, S, D = x.shape
    N = b.shape[-1]
    nclus = -(-(-(-D // channels)) // cluster)
    pad = nclus * cluster * channels - D
    widen = lambda t: torch.nn.functional.pad(t.to(f32), (0, pad))
    a = -torch.exp(a_log.to(f32))
    a2 = a * torch.tensor(LOG2E, dtype=f32)
    a, a2 = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (a, a2))
    x32, dt32, gy32, dv = widen(x), widen(dt), widen(gy), widen(d)
    b32, c32 = b.to(f32), c.to(f32)
    bnd = torch.nn.functional.pad(bounds.to(f32), (0, 0, 0, pad))
    Dp = D + pad
    dx = torch.empty((B, S, Dp), dtype=f32, device=x.device)
    ddt = torch.empty_like(dx)
    part = torch.empty((B, nclus, S, 2 * N), dtype=f32, device=x.device)
    da_rows = torch.zeros((B, Dp, N), dtype=f32, device=x.device)
    dd_rows = torch.zeros((B, Dp), dtype=f32, device=x.device)
    g = torch.zeros((B, Dp, N), dtype=f32, device=x.device)

    def step(h, t):
        at = torch.exp2(dt32[:, t, :, None] * a2)
        return at, at * h + (dt32[:, t] * x32[:, t])[..., None] * \
            b32[:, t, None, :]

    for k in reversed(range(bnd.shape[0])):
        t0 = k * chunk
        subs = [range(s0, min(S, s0 + sub))
                for s0 in range(t0, min(S, t0 + chunk), sub)]
        starts, h = [], bnd[k]
        for ts in subs:
            starts.append(h)
            for t in ts:
                h = step(h, t)[1]
        for ts, h in reversed(list(zip(subs, starts))):
            hp, av = [], []
            for t in ts:
                hp.append(h)
                at, h = step(h, t)
                av.append(at)
            for i, t in reversed(list(enumerate(ts))):
                g = gy32[:, t, :, None] * c32[:, t, None, :] + g
                e = g * hp[i] * av[i]
                gb = torch.sum(g * b32[:, t, None, :], dim=-1)
                ddt[:, t] = x32[:, t] * gb + torch.sum(e * a, dim=-1)
                dx[:, t] = dt32[:, t] * gb + dv * gy32[:, t]
                da_rows += e * dt32[:, t, :, None]
                dd_rows += gy32[:, t] * x32[:, t]
                v = torch.cat([g * (dt32[:, t] * x32[:, t])[..., None],
                               gy32[:, t, :, None] * h], dim=-1)
                v = v.view(B, nclus, cluster, channels, 2 * N).sum(dim=3)
                s = v[:, :, 0]
                for q in range(1, cluster):
                    s = s + v[:, :, q]
                part[:, :, t] = s
                g = av[i] * g
                h = hp[i]
    dbc = part[:, 0]
    for q in range(1, nclus):
        dbc = dbc + part[:, q]
    da, dd = da_rows[0], dd_rows[0]
    for r in range(1, B):
        da, dd = da + da_rows[r], dd + dd_rows[r]
    return (dx[..., :D].to(x.dtype), ddt[..., :D].contiguous(),
            dbc[..., :N].to(b.dtype), dbc[..., N:].to(c.dtype), da[:D],
            dd[:D])
