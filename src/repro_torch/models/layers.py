"""Core layers of the port: norms, activations, RoPE, plain attention.

Port of ``repro.models.layers``.  Each function keeps the
reference's arithmetic: reductions and softmax in fp32, operands of the two
attention products in the input dtype with fp32 accumulation, the same mask
order and the same finite ``NEG_INF`` fill.  ``blockwise_attention`` and
``decode_attention`` are the plain versions of the two hand-written CUDA
kernels in ``repro_torch.kernels``; on a CPU tensor the kernel wrappers
call them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(kind: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


# ---------------------------------------------------------------------------
# activations (gelu is the tanh form, as jax.nn.gelu defaults to)
# ---------------------------------------------------------------------------

def _relu2(x):
    return torch.square(torch.relu(x))


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "relu2": _relu2,
}


def activation(name: str):
    return _ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# rotary embedding, computed from positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) (D even); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv                     # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# plain attention
# ---------------------------------------------------------------------------

def _block_mask(qpos, kpos, valid_len, *, causal, window, is_global):
    """(B|1, Sq, blk) mask, in the reference's order: valid length, causal,
    then the sliding window unless the layer is global."""
    vl = valid_len.reshape(-1)                              # (B|1,)
    mask = kpos[None, None, :] < vl[:, None, None]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
    if window:
        w_ok = kpos[None, None, :] > (qpos[None, :, None] - window)
        if is_global is not None:
            w_ok = w_ok | bool(is_global)
        mask = mask & w_ok
    return mask


def _flash_fwd_pass(q, k, v, *, causal, window, block_size, logit_cap,
                    q_offset, valid_len, is_global):
    """The forward loop over KV blocks (k, v padded to whole blocks):
    (out in q's dtype, lse (B, Sq, Hq) fp32)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    nblk = k.shape[1] // block_size
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qpos = torch.arange(Sq, device=dev) + q_offset
    qf = q.float()
    acc = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, Hq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=dev)
    for i in range(nblk):
        sl = slice(i * block_size, (i + 1) * block_size)
        kpos = i * block_size + torch.arange(block_size, device=dev)
        kexp = k[:, sl].repeat_interleave(groups, dim=2)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kexp.float()) * scale
        if logit_cap > 0.0:
            s = logit_cap * torch.tanh(s / logit_cap)
        mask = _block_mask(qpos, kpos, valid_len, causal=causal,
                           window=window, is_global=is_global)
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        resc = torch.exp(m - m_new)
        vexp = v[:, sl].repeat_interleave(groups, dim=2)
        acc = acc * resc[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(v.dtype).float(), vexp.float())
        l = l * resc + p.sum(dim=-1)
        m = m_new
    lsafe = torch.clamp(l, min=1e-30)
    return (acc / lsafe[..., None]).to(q.dtype), m + torch.log(lsafe)


def _flash_bwd_pass(q, k, v, out, dout, lse, *, causal, window, block_size,
                    logit_cap, q_offset, valid_len, is_global,
                    kv_grad_dtype=None):
    """Port of the reference's ``_flash_bwd``: the block scores recomputed
    from (q, k, v, lse), the GQA groups summed back onto their KV heads.
    k and v are padded to whole blocks; returns (dq, dk, dv) in the
    input dtypes, or dk and dv in ``kv_grad_dtype`` where given."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    nblk = k.shape[1] // block_size
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qpos = torch.arange(Sq, device=dev) + q_offset
    qf, doutf = q.float(), dout.float()
    delta = torch.sum(doutf * out.float(), dim=-1)              # (B,Sq,Hq)
    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for i in range(nblk):
        sl = slice(i * block_size, (i + 1) * block_size)
        kpos = i * block_size + torch.arange(block_size, device=dev)
        kexp = k[:, sl].repeat_interleave(groups, dim=2).float()
        vexp = v[:, sl].repeat_interleave(groups, dim=2).float()
        s_raw = torch.einsum("bqhd,bkhd->bqhk", qf, kexp) * scale
        s = logit_cap * torch.tanh(s_raw / logit_cap) if logit_cap > 0.0 \
            else s_raw
        mask = _block_mask(qpos, kpos, valid_len, causal=causal,
                           window=window, is_global=is_global)
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])                       # (B,Sq,Hq,blk)
        dv_h = torch.einsum("bqhk,bqhd->bkhd", p.to(v.dtype).float(), doutf)
        dp = torch.einsum("bqhd,bkhd->bqhk", doutf, vexp)
        ds = p * (dp - delta[..., None])
        if logit_cap > 0.0:
            ds = ds * (1.0 - torch.square(torch.tanh(s_raw / logit_cap)))
        ds = torch.where(mask[:, :, None, :], ds, 0.0)
        dsc = ds.to(k.dtype).float()
        dq = dq + torch.einsum("bqhk,bkhd->bqhd", dsc, kexp) * scale
        dk_h = torch.einsum("bqhk,bqhd->bkhd", dsc, qf) * scale
        # fold GQA: sum the query-head groups back onto their kv heads
        dks.append(dk_h.reshape(B, block_size, Hkv, groups, D).sum(3))
        dvs.append(dv_h.reshape(B, block_size, Hkv, groups, D).sum(3))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(kv_grad_dtype or k.dtype),
            torch.cat(dvs, 1).to(kv_grad_dtype or v.dtype))


class _Flash(torch.autograd.Function):
    """``blockwise_attention`` with the reference's custom VJP: the forward
    saves (q, k, v, out, lse), the backward recomputes the block scores."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len, kw):
        out, lse = _flash_fwd_pass(q, k, v, valid_len=valid_len, **kw)
        ctx.save_for_backward(q, k, v, out, lse, valid_len)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, valid_len = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_pass(q, k, v, out, dout, lse,
                                     valid_len=valid_len, **ctx.kw)
        return dq, dk, dv, None, None


def _flash_setup(k, v, kv_len, block_size, dev):
    """(k, v padded to whole blocks, block size, valid length tensor)."""
    Skv = k.shape[1]
    block_size = min(block_size, Skv)
    pad = -(-Skv // block_size) * block_size - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    valid_len = torch.as_tensor(Skv if kv_len is None else kv_len,
                                dtype=torch.int64, device=dev)
    return k, v, block_size, valid_len


def blockwise_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                        window: int = 0, kv_len=None, block_size: int = 512,
                        logit_cap: float = 0.0, is_global=None):
    """Flash-attention algorithm in plain PyTorch, forward and backward.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), Hq % Hkv == 0.  A loop over
    KV blocks of ``block_size`` with a running max and sum in fp32; scores
    in fp32, ``p`` cast to the value dtype before P.V, output in q's dtype.
    kv_len: optional scalar or per-row (B,) valid KV length.  Where autograd
    records the call, the gradient is the reference's flash backward
    (``_flash_bwd``: saves (q, k, v, out, lse) and recomputes the scores).
    """
    k, v, block_size, valid_len = _flash_setup(k, v, kv_len, block_size,
                                               q.device)
    kw = dict(causal=causal, window=window, block_size=block_size,
              logit_cap=logit_cap, q_offset=q_offset, is_global=is_global)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, valid_len, kw)
    return _flash_fwd_pass(q, k, v, valid_len=valid_len, **kw)[0]


def flash_forward(q, k, v, *, causal: bool, q_offset: int = 0,
                  window: int = 0, kv_len=None, block_size: int = 512,
                  logit_cap: float = 0.0, is_global=None):
    """``blockwise_attention``'s forward with its log-sum-exp: (out, lse
    (B, Sq, Hq) fp32, natural units of the scaled scores), the reference's
    ``_flash_fwd_pass``."""
    k, v, block_size, valid_len = _flash_setup(k, v, kv_len, block_size,
                                               q.device)
    return _flash_fwd_pass(q, k, v, causal=causal, window=window,
                           block_size=block_size, logit_cap=logit_cap,
                           q_offset=q_offset, valid_len=valid_len,
                           is_global=is_global)


def flash_backward(q, k, v, out, dout, lse, *, causal: bool,
                   q_offset: int = 0, window: int = 0, kv_len=None,
                   block_size: int = 512, logit_cap: float = 0.0,
                   is_global=None, kv_grad_dtype=None):
    """(dq, dk, dv) of ``blockwise_attention`` from a forward's ``out`` and
    ``lse`` and the output gradient ``dout``: the reference's
    ``_flash_bwd`` on given inputs (the flash backward kernel's plain
    version); dk and dv in ``kv_grad_dtype`` where given, unrounded."""
    Skv = k.shape[1]
    kp, vp, block_size, valid_len = _flash_setup(k, v, kv_len, block_size,
                                                 q.device)
    dq, dk, dv = _flash_bwd_pass(
        q, kp, vp, out, dout, lse, causal=causal, window=window,
        block_size=block_size, logit_cap=logit_cap, q_offset=q_offset,
        valid_len=valid_len, is_global=is_global,
        kv_grad_dtype=kv_grad_dtype)
    return dq, dk[:, :Skv], dv[:, :Skv]


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     logit_cap: float = 0.0, is_global=None):
    """Single-token attention against a preallocated cache (padded read).

    q: (B, 1, Hq, D); caches: (B, T, Hkv, D); cache_len: int or (B,) valid
    entries per row, the current token included.
    """
    B, _, Hq, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    groups = Hq // Hkv
    cache_len = torch.as_tensor(cache_len, device=q.device).expand(B)
    kexp = k_cache.repeat_interleave(groups, dim=2)
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(),
                     kexp.float()) / math.sqrt(D)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    pos = torch.arange(T, device=q.device)
    mask = pos[None, None, :] < cache_len[:, None, None]
    if window:
        w_ok = pos[None, None, :] > (cache_len[:, None, None] - 1 - window)
        if is_global is not None:
            w_ok = w_ok | bool(is_global)
        mask = mask & w_ok
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vexp = v_cache.repeat_interleave(groups, dim=2)
    out = torch.einsum("bht,bthd->bhd", p.to(v_cache.dtype).float(),
                       vexp.float())
    return out[:, None].to(q.dtype)


def scatter_kv(cache: torch.Tensor, new: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, T, ...) at per-row
    positions ``pos`` (B,).  IN PLACE: the cache tensor itself is updated
    and returned.  Positions clamp to [0, T-1], as the reference's
    dynamic_update_slice clamps its start index."""
    B, T = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    cache[rows, pos.clamp(0, T - 1)] = new[:, 0].to(cache.dtype)
    return cache
