"""Core layers of the port: norms, activations, RoPE, plain attention.

Port of ``repro.models.layers`` (forward only).  Each function keeps the
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


def blockwise_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                        window: int = 0, kv_len=None, block_size: int = 512,
                        logit_cap: float = 0.0, is_global=None):
    """Flash-attention algorithm in plain PyTorch, forward only.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), Hq % Hkv == 0.  A loop over
    KV blocks of ``block_size`` with a running max and sum in fp32; scores
    in fp32, ``p`` cast to the value dtype before P.V, output in q's dtype.
    kv_len: optional scalar or per-row (B,) valid KV length.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    block_size = min(block_size, Skv)
    nblk = -(-Skv // block_size)
    pad = nblk * block_size - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    valid_len = torch.as_tensor(Skv if kv_len is None else kv_len,
                                dtype=torch.int64, device=dev)
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
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


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
