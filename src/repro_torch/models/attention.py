"""GQA, cross-attention and MLA blocks of the port
(``repro.models.attention``).

Parameters keep the reference's einsum layouts, ``wq/wk/wv (d, H, hd)`` and
``wo (Hq, hd, d)``, so weights bridge without transposes; the projections
reshape them to matrices at use (views, no copies).  Cache per layer:
``{"k": (B, T, Hkv, D), "v": (B, T, Hkv, D)}``, updated IN PLACE.

With ``use_kernels``, full-sequence attention (prefill, encoders, and
unmasked cross-attention over a whole encoder output, as training runs
it) goes through the flash kernel's wrapper and decode attention, self
and cross, through the ragged decode kernel's; on CPU tensors each
wrapper runs its plain version.  Cross-attention over a right-padded
encoder output (a serving prefill's ``src_len``) stays stock torch, as
the reference computes it outside any kernel.

MLA (DeepSeek-V2's multi-head latent attention) caches the compressed
latent per layer instead, ``{"ckv": (B, T, R), "krope": (B, T, Dr)}``.
Its prefill expands the latents to per-head K and V and runs the flash
kernel at the qk head dim (Dn + Dr: 192 for deepseek-v2-lite), with V
zero-padded to it and sliced back after, as the reference pads it for
its shared kernel.  Its decode step is the reference's absorbed form, a
chain of fp32 einsums over the latent cache outside any kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import partitioning as part
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ragged_decode import ragged_decode_attention
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def gqa_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device) -> Params:
    """Random weights with the reference's fan-in scaled init (the numbers
    differ from ``jax.random``'s; tests bridge JAX weights instead)."""
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    std = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, hq, hd), std, dtype, device),
        "wk": _normal(gen, (d, hkv, hd), std, dtype, device),
        "wv": _normal(gen, (d, hkv, hd), std, dtype, device),
        "wo": _normal(gen, (hq, hd, d), 1.0 / math.sqrt(hq * hd), dtype,
                      device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=device)
    return p


def gqa_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical specs of ``gqa_init``'s leaves (the reference's
    annotations): query heads on "heads", KV heads on "kv_heads"."""
    p = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if cfg.qkv_bias:
        p.update(bq=("heads", None), bk=("kv_heads", None),
                 bv=("kv_heads", None))
    if cfg.qk_norm:
        p.update(q_norm=(None,), k_norm=(None,))
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd).  Weights are cast to
    x's dtype at use, as the reference does (fp32 training masters); at
    serving they already are, and ``.to`` returns them as they are."""
    d, h, hd = w.shape
    w2 = part.whole_groups(w.reshape(d, h * hd), -1, h)
    y = part.whole_groups(part.rows_matmul(x, w2.to(x.dtype)), -1, h)
    return y.reshape(*x.shape[:-1], h, hd)


def _out(o, wo):
    """o (B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = wo.shape
    return part.rows_matmul(o.reshape(*o.shape[:-2], h * hd),
                            wo.reshape(h * hd, d).to(o.dtype))


def _project_qkv(p: Params, cfg: ModelConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg: ModelConfig) -> int:
    return cfg.window_size if cfg.attn_type == "sliding" else 0


# The layout the attention kernels run in on a mesh: batch over the data
# dims, query heads over the model dim, KV heads replicated.
_KERNEL_LAYOUT = part.ShardingRules({"batch": ("pod", "data"),
                                     "heads": "model"})


def _kv_heads_of(index: int, per: int, Hq: int, Hkv: int, device=None):
    """The KV heads that query heads ``[index * per, (index + 1) * per)``
    attend under GQA (``Hq // Hkv`` query heads to a KV head): a slice
    where those heads cover whole groups or lie within one; where they
    straddle groups, a (per,) index tensor on ``device``, one KV head per
    query head.  Training (``_attend``) and serving (``gqa_prefill``,
    ``gqa_step``) slice a rank's KV heads with it."""
    G = Hq // Hkv
    h0 = index * per
    if per % G == 0 or G % per == 0:
        return slice(h0 // G, h0 // G + max(per // G, 1))
    return (torch.arange(per, device=device) + h0) // G


def _local_heads(mesh, q_place, Hq: int, Hkv: int):
    """(model mesh dim, slice of KV heads) of this rank's query heads, or
    None where the model dim does not split the heads."""
    names = list(mesh.mesh_dim_names)
    if "model" not in names or not q_place[names.index("model")].is_shard():
        return None
    mi = names.index("model")
    per = Hq // mesh.size(mi)
    return mi, _kv_heads_of(mesh.get_local_rank(mi), per, Hq, Hkv)


def _kv_of_local_heads(cfg: ModelConfig, hq: int, k, v, tp):
    """K and V (B, T, heads, D) for this rank's ``hq`` query heads on a
    tensor-parallel mesh.  Heads whole, or KV heads split with the query
    heads (the degree divides both): as they are.  Query heads split over
    whole KV heads: those of this rank's query heads (``_kv_heads_of``)."""
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    if tp is None or hq == Hq or k.shape[2] < Hkv:
        return k, v
    sel = _kv_heads_of(tp.index, hq, Hq, Hkv, k.device)
    if isinstance(sel, slice):
        return k[:, :, sel], v[:, :, sel]
    return k.index_select(2, sel), v.index_select(2, sel)


def _reduce_heads(y, cfg: ModelConfig, wo, tp):
    """The attention output's partial sum over this rank's query heads
    (``wo`` row-parallel), summed over the model group."""
    if tp is not None and wo.shape[0] < cfg.num_heads:
        tp.all_reduce(y)
    return y


def _attend(q, k, v, *, use_kernels: bool, **kw):
    """Full-sequence attention through the flash kernel's wrapper (or the
    plain blockwise version).  DTensor operands run on each rank's local
    shard: q redistributed to batch on the data dims and heads on the
    model dim, k and v to batch on the data dims, and each rank passes the
    kernel the KV heads of its query heads' groups (kv_heads are
    replicated; their gradient is a partial sum over the model dim)."""
    fn = flash_attention if use_kernels else L.blockwise_attention
    if not part.is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial

    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    qspec = part.fit_spec(_KERNEL_LAYOUT.spec(("batch", None, "heads")),
                          q.shape, mesh)
    if qspec[2] is not None:
        per = Hq // part.mesh_sizes(mesh)["model"]
        if not isinstance(_kv_heads_of(0, per, Hq, Hkv), slice):
            qspec = qspec[:2] + (None,)     # heads straddle KV groups
    q_place = part.placements(qspec, mesh)
    kv_place = part.placements(qspec[:1], mesh)
    q = q.redistribute(mesh, q_place)
    k, v = (t.redistribute(mesh, kv_place) for t in (k, v))
    heads = _local_heads(mesh, q_place, Hq, Hkv)
    if heads is None:
        kl, vl = k.to_local(), v.to_local()
    else:
        mi, sel = heads
        grad = list(kv_place)
        grad[mi] = Partial()
        kl, vl = (t.to_local(grad_placements=grad)[:, :, sel]
                  for t in (k, v))
    out = fn(q.to_local(), kl, vl, **kw)
    return DTensor.from_local(out, mesh, q_place, run_check=False)


def gqa_fwd(p: Params, cfg: ModelConfig, x, positions, *, causal: bool = True,
            is_global: bool = False, kv_len=None, use_kernels: bool = True,
            tp=None):
    """Full-sequence attention without a cache (encoders, embedding
    stacks).  kv_len: optional (B,) int32 valid lengths of right-padded
    rows: each row masks its own key padding, so its valid outputs do not
    depend on the padded length.  ``tp``: as in ``gqa_prefill``."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    k, v = _kv_of_local_heads(cfg, q.shape[2], k, v, tp)
    o = _attend(q, k, v, use_kernels=use_kernels, causal=causal,
                window=_window(cfg), logit_cap=cfg.logit_softcap,
                is_global=is_global, kv_len=kv_len)
    return _reduce_heads(_out(o, p["wo"]), cfg, p["wo"], tp)


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p: Params, cfg: ModelConfig, x, positions, cache: Params, *,
                is_global: bool = False, use_kernels: bool = True, tp=None):
    """Prefill: causal attention, and K/V written into the cache at [0, S)
    in place.  ``use_kernels=False`` runs the plain blockwise attention
    whatever the device.  ``tp`` (a ``partitioning.TPShard``): the weights
    and cache are this rank's shards; the kernel runs on its local heads
    and the row-parallel ``wo`` product is summed over the model group."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    kw = dict(causal=True, window=_window(cfg), logit_cap=cfg.logit_softcap,
              is_global=is_global)
    ka, va = _kv_of_local_heads(cfg, q.shape[2], k, v, tp)
    if use_kernels:
        o = flash_attention(q, ka, va, **kw)
    else:
        o = L.blockwise_attention(q, ka, va, **kw)
    S = x.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _reduce_heads(_out(o, p["wo"]), cfg, p["wo"], tp), cache


def gqa_step(p: Params, cfg: ModelConfig, x1, cache: Params, pos, *,
             is_global: bool = False, use_kernels: bool = False,
             kv_bound: Optional[int] = None, live=None, tp=None):
    """Decode one token.  x1: (B, 1, d); pos: (B,) int32 per-row positions.

    With ``use_kernels`` the ragged kernel reads only ``cache[:, :kv_bound]``
    (a strided view, never copied; the bound covers every live row's
    ``pos + 1``) and ``live`` marks empty slots.  The full-size cache is
    written either way.  ``tp``: as in ``gqa_prefill``."""
    q, k, v = _project_qkv(p, cfg, x1, pos[:, None])
    ck = L.scatter_kv(cache["k"], k, pos)
    cv = L.scatter_kv(cache["v"], v, pos)
    kw = dict(window=_window(cfg), is_global=is_global,
              logit_cap=cfg.logit_softcap)
    if use_kernels:
        kb = ck.shape[1] if kv_bound is None else kv_bound
        ka, va = _kv_of_local_heads(cfg, q.shape[2], ck[:, :kb],
                                    cv[:, :kb], tp)
        o = ragged_decode_attention(q, ka, va, pos + 1, live=live, **kw)
    else:
        ka, va = _kv_of_local_heads(cfg, q.shape[2], ck, cv, tp)
        o = L.decode_attention(q, ka, va, pos + 1, **kw)
    return _reduce_heads(_out(o, p["wo"]), cfg, p["wo"], tp), cache


# ---------------------------------------------------------------------------
# cross-attention (enc-dec decoder): K/V from the encoder output, computed
# once at prefill into the slot's cross cache
# ---------------------------------------------------------------------------

def cross_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
               device) -> Params:
    return gqa_init(gen, cfg, dtype=dtype, device=device)


def cross_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    return gqa_specs(cfg)


def _cross_q(p: Params, cfg: ModelConfig, x):
    q = _proj(x, p["wq"])
    return q + p["bq"] if cfg.qkv_bias else q


def cross_kv(p: Params, cfg: ModelConfig, enc_out):
    """Encoder output (B, S_src, d) -> cross K, V (B, S_src, Hkv, hd): on
    a tensor-parallel mesh the KV heads this rank holds (``wk``, ``wv``
    and their biases split on "kv_heads" where the degree divides them)."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def cross_fwd(p: Params, cfg: ModelConfig, x, enc_out, src_len=None, *,
              use_kernels: bool = False, tp=None):
    """Cross-attention of x (B, Sq, d) over the encoder output (training,
    prefill).

    src_len: optional scalar or (B,) valid source lengths of a right-padded
    encoder output: keys at or past it are masked out of the softmax.  The
    masked path is the reference's einsum form (scores (B, Hq, Sq, S_src),
    small for the decoder prompts a serving prefill runs); without it the
    bidirectional blockwise attention runs, as in the reference: with
    ``use_kernels`` through the flash kernel's wrapper (Skv = S_src apart
    from Sq; under autograd its forward with lse and backward kernels),
    else the plain version.  ``tp``: as in ``gqa_prefill``; the rank's
    query heads attend the KV heads of their groups, the encoder output
    is whole on every rank."""
    q = _cross_q(p, cfg, x)
    k, v = _kv_of_local_heads(cfg, q.shape[2], *cross_kv(p, cfg, enc_out),
                              tp)
    if src_len is None:
        o = _attend(q, k, v, use_kernels=use_kernels, causal=False)
    else:
        B, Sq, Hq, D = q.shape
        Ss, Hkv = k.shape[1], k.shape[2]
        kexp = k.repeat_interleave(Hq // Hkv, dim=2)
        vexp = v.repeat_interleave(Hq // Hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         kexp.float()) / math.sqrt(D)
        lens = torch.as_tensor(src_len, device=q.device).expand(B)
        mask = (torch.arange(Ss, device=q.device)[None, None, None, :]
                < lens[:, None, None, None])
        s = torch.where(mask, s, L.NEG_INF)
        w = torch.softmax(s, dim=-1).to(vexp.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w.float(),
                         vexp.float()).to(q.dtype)
    return _reduce_heads(_out(o, p["wo"]), cfg, p["wo"], tp)


def cross_step(p: Params, cfg: ModelConfig, x1, ck, cv, src_len, *,
               use_kernels: bool = False, src_bound: Optional[int] = None,
               live=None, tp=None):
    """Decode-step cross-attention of x1 (B, 1, d) over the slot's cross
    cache (B, max_src, Hkv, hd), each row masked at its ``src_len``.  With
    ``use_kernels`` the ragged kernel reads only ``[:, :src_bound]`` (the
    bound covers every live row's source) and skips dead slots.  ``tp``:
    as in ``gqa_step``; the cross cache holds the rank's KV heads where
    the degree divides them."""
    q = _cross_q(p, cfg, x1)
    if use_kernels:
        sb = ck.shape[1] if src_bound is None else src_bound
        ka, va = _kv_of_local_heads(cfg, q.shape[2], ck[:, :sb], cv[:, :sb],
                                    tp)
        o = ragged_decode_attention(q, ka, va, src_len, live=live)
    else:
        ka, va = _kv_of_local_heads(cfg, q.shape[2], ck, cv, tp)
        o = L.decode_attention(q, ka, va, src_len)
    return _reduce_heads(_out(o, p["wo"]), cfg, p["wo"], tp)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1)
#
#   c_kv   = rms_norm(x @ W_dkv)            (B, S, R)       latent KV
#   k_rope = rope(x @ W_kr)                 (B, S, Dr)      shared by heads
#   k_nope = c_kv @ W_uk (B, S, H, Dn);  v = c_kv @ W_uv (B, S, H, Dv)
#   q      = x @ W_q, or rms_norm(x @ W_dq) @ W_uq       (B, S, H, Dn + Dr)
# Decode attends in the latent space (W_uk absorbed into q, W_uv applied
# after):  score = q_nope W_uk^T c_kv + q_rope k_rope;  out = (p c_kv) W_uv
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    kw = dict(dtype=dtype, device=device)
    p = {
        "w_dkv": _normal(gen, (d, r), 1.0 / math.sqrt(d), **kw),
        "w_kr": _normal(gen, (d, dr), 1.0 / math.sqrt(d), **kw),
        "w_uk": _normal(gen, (r, h, dn), 1.0 / math.sqrt(r), **kw),
        "w_uv": _normal(gen, (r, h, dv), 1.0 / math.sqrt(r), **kw),
        "wo": _normal(gen, (h, dv, d), 1.0 / math.sqrt(h * dv), **kw),
        "kv_norm": torch.ones(r, dtype=torch.float32, device=device),
    }
    if m.q_lora_rank:
        qr = m.q_lora_rank
        p["w_dq"] = _normal(gen, (d, qr), 1.0 / math.sqrt(d), **kw)
        p["w_uq"] = _normal(gen, (qr, h, dn + dr), 1.0 / math.sqrt(qr), **kw)
        p["q_norm"] = torch.ones(qr, dtype=torch.float32, device=device)
    else:
        p["w_q"] = _normal(gen, (d, h, dn + dr), 1.0 / math.sqrt(d), **kw)
    return p


def mla_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical specs of ``mla_init``'s leaves."""
    p = {"w_dkv": ("embed", "lora"), "w_kr": ("embed", None),
         "w_uk": ("lora", "heads", None), "w_uv": ("lora", "heads", None),
         "wo": ("heads", None, "embed"), "kv_norm": (None,)}
    if cfg.mla.q_lora_rank:
        p.update(w_dq=("embed", "lora"), w_uq=("lora", "heads", None),
                 q_norm=(None,))
    else:
        p["w_q"] = ("embed", "heads", None)
    return p


def _mla_q(p: Params, cfg: ModelConfig, x, positions):
    m = cfg.mla
    if m.q_lora_rank:
        cq = L.rms_norm(part.rows_matmul(x, p["w_dq"].to(x.dtype)),
                        p["q_norm"], cfg.norm_eps)
        q = _proj(cq, p["w_uq"])
    else:
        q = _proj(x, p["w_q"])
    dn = m.qk_nope_head_dim
    return q[..., :dn], L.apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latents(p: Params, cfg: ModelConfig, x, positions):
    ckv = L.rms_norm(part.rows_matmul(x, p["w_dkv"].to(x.dtype)),
                     p["kv_norm"], cfg.norm_eps)
    kr = L.apply_rope(part.rows_matmul(x, p["w_kr"].to(x.dtype))[
        :, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _mla_attend(p: Params, cfg: ModelConfig, x, positions, ckv, kr, *,
                use_kernels: bool):
    """Causal attention over the latents expanded to per-head K and V: the
    flash kernel at the qk head dim, V zero-padded to it.  Under autograd
    the kernel path's backward runs at that head dim too; the pad's
    backward drops the padded columns' gradient, which the slice after
    the attention makes zero."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    k_nope = _proj(ckv, p["w_uk"])
    v = _proj(ckv, p["w_uv"])
    B, S, H, _ = k_nope.shape
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
    # zero columns by a concatenation, the op a DTensor v takes alike
    zeros = torch.zeros_like(v[..., :1]).expand(*v.shape[:-1],
                                                dqk - m.v_head_dim)
    vpad = torch.cat([v, zeros], dim=-1)
    o = _attend(q, k, vpad, use_kernels=use_kernels, causal=True)
    return _out(o[..., :m.v_head_dim], p["wo"])


def mla_fwd(p: Params, cfg: ModelConfig, x, positions, *,
            use_kernels: bool = True, tp=None):
    """Full-sequence causal MLA without a cache.  ``tp``: as in
    ``mla_prefill``."""
    ckv, kr = _mla_latents(p, cfg, x, positions)
    return _reduce_heads(_mla_attend(p, cfg, x, positions, ckv, kr,
                                     use_kernels=use_kernels),
                         cfg, p["wo"], tp)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Params:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_prefill(p: Params, cfg: ModelConfig, x, positions, cache: Params, *,
                use_kernels: bool = True, tp=None):
    """Prefill: the latents, computed once, feed the attention and are
    written into the cache at [0, S) in place.  ``tp`` (a
    ``partitioning.TPShard``): the query, ``w_uk``, ``w_uv`` and ``wo``
    leaves hold this rank's heads where the degree divides them; the
    latent projections and the latent cache have no heads dim and are
    whole on every rank; the flash kernel runs on the local heads and
    the row-parallel ``wo`` product is summed over the model group."""
    ckv, kr = _mla_latents(p, cfg, x, positions)
    y = _reduce_heads(_mla_attend(p, cfg, x, positions, ckv, kr,
                                  use_kernels=use_kernels),
                      cfg, p["wo"], tp)
    S = x.shape[1]
    cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :S] = kr.to(cache["krope"].dtype)
    return y, cache


def mla_step(p: Params, cfg: ModelConfig, x1, cache: Params, pos, *,
             use_kernels: bool = False, kv_bound: Optional[int] = None,
             tp=None):
    """Absorbed MLA decode of one token, x1 (B, 1, d), at per-row positions
    ``pos`` (B,): scores, softmax and the latent output in fp32, scale
    1/sqrt(Dn + Dr).  With ``use_kernels`` the latent read is bounded to
    ``[:, :kv_bound]`` (the masked suffix scores nothing either way).
    ``tp``: as in ``mla_prefill``; each rank scores its heads over the
    whole latent cache."""
    m = cfg.mla
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x1, positions)        # (B, 1, H, Dn/Dr)
    ckv1, kr1 = _mla_latents(p, cfg, x1, positions)
    cckv = L.scatter_kv(cache["ckv"], ckv1, pos)
    ckr = L.scatter_kv(cache["krope"], kr1, pos)
    att_ckv, att_kr = cckv, ckr
    if use_kernels and kv_bound is not None:
        att_ckv, att_kr = cckv[:, :kv_bound], ckr[:, :kv_bound]
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])[:, 0]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ckv32 = att_ckv.float()
    s = (torch.einsum("bhr,btr->bht", q_abs.float(), ckv32)
         + torch.einsum("bhk,btk->bht", q_rope[:, 0].float(),
                        att_kr.float())) * scale
    T = att_ckv.shape[1]
    mask = (torch.arange(T, device=x1.device)[None, None, :]
            < (pos + 1)[:, None, None])
    s = torch.where(mask, s, L.NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", w, ckv32)
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(x1.dtype), p["w_uv"])
    y = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None]
    return _reduce_heads(y.contiguous(), cfg, p["wo"], tp), cache
