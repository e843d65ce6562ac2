"""Transformer stacks of the port (``repro.models.transformer``): dense
GQA, MoE (with MLA or GQA attention), attention-free Mamba and hybrid
(attention beside Mamba in every layer: hymba) decoders, and the
encoder-decoder's bidirectional encoder and cross-attending decoder.

The reference scans one stacked layer body with ``lax.scan``; here a
Python loop runs over a list of per-layer parameter dicts,
``{"prologue": [...], "layers": [...]}``: the prologue holds the
reference's unscanned layers (DeepSeek's first-k-dense layers, whose FFN
has another width), ``layers`` its scanned ones.  The decode cache keeps
the reference's structure, ``{"prologue": [per-layer caches], "scanned":
{"attn": {"k", "v"} or {"ckv", "krope"}} or {"ssm": {"conv", "h"}},
"pos"}``, with stacked scanned leaves (layer axis 0, slot axis 1: KV (L,
B, T, Hkv, D), MLA latents (L, B, T, R) and (L, B, T, Dr), conv window
(L, B, w-1, d_in), state (L, B, d_in, N) fp32) and slot-leading prologue
leaves, all updated IN PLACE layer by layer.  A hybrid layer's cache holds
both ``attn`` and ``ssm``.  An enc-dec decoder's cache adds
``scanned["cross"] = {"k", "v"}`` (L, B, max_src, Hkv, D), the reference's
per-layer ``cross_k`` and ``cross_v``.

A hybrid layer (``cfg.hybrid_parallel``) runs GQA attention and a Mamba
block on the same normed input and adds ``0.5 * (rmsnorm(a) +
rmsnorm(s))`` to the residual, each output under its own RMSNorm
(``attn_out_norm``, ``ssm_out_norm``); sliding-window layers but the
``global_attn_layers`` ones.  Without a cache its Mamba block runs
``ssm.mamba_fwd`` from a zero state, as an SSM layer's does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

PyTree = Any


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the stacks the port does not cover: it serves dense and
    MoE decoders (GQA or MLA attention), attention-free SSM (Mamba) and
    hybrid decoders, and dense GQA encoder-decoders.  An SSM encoder is no
    reference arch."""
    if cfg.is_encdec and cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: an ssm encoder belongs to no slice of the "
            "PyTorch port: the reference's enc-dec archs are dense")


def norm_init(kind: str, dim: int, device) -> Dict[str, torch.Tensor]:
    """Norm parameters stay fp32: the norms compute in fp32."""
    p = {"scale": torch.ones(dim, dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(dim, dtype=torch.float32, device=device)
    return p


def _layer_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device,
                cross: bool = False, dense_override_ff: int = 0):
    """One layer; ``cross`` adds cross-attention (enc-dec decoder);
    ``dense_override_ff`` > 0 gives a dense FFN of that width in place of
    the MoE (prologue layers)."""
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, PyTree] = {"ln1": norm_init(cfg.norm, cfg.d_model, device)}
    if cfg.hybrid_parallel:
        p["attn"] = A.gqa_init(gen, cfg, **kw)
        p["ssm"] = S.mamba_init(gen, cfg, **kw)
        p["attn_out_norm"] = norm_init("rmsnorm", cfg.d_model, device)
        p["ssm_out_norm"] = norm_init("rmsnorm", cfg.d_model, device)
    elif cfg.ssm is not None:
        p["ssm"] = S.mamba_init(gen, cfg, **kw)
    elif cfg.mla is not None:
        p["attn"] = A.mla_init(gen, cfg, **kw)
    else:
        p["attn"] = A.gqa_init(gen, cfg, **kw)
    if cross:
        p["ln_cross"] = norm_init(cfg.norm, cfg.d_model, device)
        p["cross"] = A.cross_init(gen, cfg, **kw)
    if dense_override_ff:
        p["ln2"] = norm_init(cfg.norm, cfg.d_model, device)
        p["ffn"] = M.ffn_init(gen, cfg, dense_override_ff, **kw)
    elif cfg.moe is not None:
        p["ln2"] = norm_init(cfg.norm, cfg.d_model, device)
        p["moe"] = M.moe_init(gen, cfg, **kw)
    elif cfg.d_ff:
        p["ln2"] = norm_init(cfg.norm, cfg.d_model, device)
        p["ffn"] = M.ffn_init(gen, cfg, cfg.d_ff, **kw)
    return p


def _ffn(p, cfg: ModelConfig, x, moe_dispatch: str = "einsum"):
    """The FFN sublayer: dense, or MoE.  Returns (x, aux): the MoE layer's
    load-balance loss (fp32, 0-d), None for a dense or FFN-less layer.
    Training sums it (``decoder_fwd``); serving drops it."""
    aux = None
    if "moe" in p:
        h2 = L.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
        y, aux = M.moe_apply(p["moe"], cfg, h2, dispatch_impl=moe_dispatch)
        x = x + y
    elif "ffn" in p:
        h2 = L.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
        x = x + M.ffn_apply(p["ffn"], cfg, h2)
    return x, aux


def _hybrid(p, cfg: ModelConfig, a, s):
    """The hybrid mixer's output from its attention and Mamba outputs:
    0.5 (rmsnorm(a) + rmsnorm(s))."""
    a = L.apply_norm("rmsnorm", p["attn_out_norm"], a, cfg.norm_eps)
    s = L.apply_norm("rmsnorm", p["ssm_out_norm"], s, cfg.norm_eps)
    return 0.5 * (a + s)


def _layer_fwd(p, cfg: ModelConfig, x, positions, *, causal: bool,
               is_global: bool, kv_len, use_kernels: bool,
               moe_dispatch: str = "einsum"):
    """Residual layer without a cache (training, encoders, embedding
    stacks): (x, aux) as ``_ffn`` gives them.  An SSM layer runs
    ``ssm.mamba_fwd`` from a zero state (its scan's backward under
    autograd)."""
    h = L.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if cfg.hybrid_parallel:
        a = A.gqa_fwd(p["attn"], cfg, h, positions, causal=causal,
                      is_global=is_global, kv_len=kv_len,
                      use_kernels=use_kernels)
        y = _hybrid(p, cfg, a, S.mamba_fwd(p["ssm"], cfg, h,
                                           use_kernels=use_kernels))
    elif "ssm" in p:
        y = S.mamba_fwd(p["ssm"], cfg, h, use_kernels=use_kernels)
    elif cfg.mla is not None:
        y = A.mla_fwd(p["attn"], cfg, h, positions, use_kernels=use_kernels)
    else:
        y = A.gqa_fwd(p["attn"], cfg, h, positions, causal=causal,
                      is_global=is_global, kv_len=kv_len,
                      use_kernels=use_kernels)
    return _ffn(p, cfg, x + y, moe_dispatch)


def _cross(p, cfg: ModelConfig, x, fn):
    """The cross-attention sublayer, when the layer has one."""
    if "cross" not in p:
        return x
    hc = L.apply_norm(cfg.norm, p["ln_cross"], x, cfg.norm_eps)
    return x + fn(hc)


def _layer_prefill(p, cfg: ModelConfig, x, positions, cache, *,
                   is_global: bool, use_kernels: bool, enc_out=None,
                   src_len=None, moe_dispatch: str = "einsum"):
    h = L.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if cfg.hybrid_parallel:
        a, cache["attn"] = A.gqa_prefill(p["attn"], cfg, h, positions,
                                         cache["attn"], is_global=is_global,
                                         use_kernels=use_kernels)
        s, cache["ssm"] = S.mamba_prefill(p["ssm"], cfg, h, cache["ssm"],
                                          use_kernels=use_kernels)
        y = _hybrid(p, cfg, a, s)
    elif "ssm" in p:
        y, cache["ssm"] = S.mamba_prefill(p["ssm"], cfg, h, cache["ssm"],
                                          use_kernels=use_kernels)
    elif cfg.mla is not None:
        y, cache["attn"] = A.mla_prefill(p["attn"], cfg, h, positions,
                                         cache["attn"],
                                         use_kernels=use_kernels)
    else:
        y, cache["attn"] = A.gqa_prefill(p["attn"], cfg, h, positions,
                                         cache["attn"], is_global=is_global,
                                         use_kernels=use_kernels)
    x = _cross(p, cfg, x + y, lambda hc: A.cross_fwd(
        p["cross"], cfg, hc, enc_out, src_len=src_len))
    if "cross" in p:
        ck, cv = A.cross_kv(p["cross"], cfg, enc_out)
        Ss = enc_out.shape[1]
        cache["cross"]["k"][:, :Ss] = ck.to(cache["cross"]["k"].dtype)
        cache["cross"]["v"][:, :Ss] = cv.to(cache["cross"]["v"].dtype)
    return _ffn(p, cfg, x, moe_dispatch)[0], cache


def _layer_step(p, cfg: ModelConfig, x1, cache, pos, *, is_global: bool,
                use_kernels: bool, kv_bound: Optional[int], live,
                src_len=None, src_bound: Optional[int] = None,
                moe_dispatch: str = "einsum"):
    h = L.apply_norm(cfg.norm, p["ln1"], x1, cfg.norm_eps)
    if cfg.hybrid_parallel:
        a, cache["attn"] = A.gqa_step(p["attn"], cfg, h, cache["attn"], pos,
                                      is_global=is_global,
                                      use_kernels=use_kernels,
                                      kv_bound=kv_bound, live=live)
        s, cache["ssm"] = S.mamba_step(p["ssm"], cfg, h, cache["ssm"],
                                       use_kernels=use_kernels, live=live)
        y = _hybrid(p, cfg, a, s)
    elif "ssm" in p:
        y, cache["ssm"] = S.mamba_step(p["ssm"], cfg, h, cache["ssm"],
                                       use_kernels=use_kernels, live=live)
    elif cfg.mla is not None:
        y, cache["attn"] = A.mla_step(p["attn"], cfg, h, cache["attn"], pos,
                                      use_kernels=use_kernels,
                                      kv_bound=kv_bound)
    else:
        y, cache["attn"] = A.gqa_step(p["attn"], cfg, h, cache["attn"], pos,
                                      is_global=is_global,
                                      use_kernels=use_kernels,
                                      kv_bound=kv_bound, live=live)
    x1 = _cross(p, cfg, x1 + y, lambda hc: A.cross_step(
        p["cross"], cfg, hc, cache["cross"]["k"], cache["cross"]["v"],
        src_len, use_kernels=use_kernels, src_bound=src_bound, live=live))
    return _ffn(p, cfg, x1, moe_dispatch)[0], cache


def _prologue_plan(cfg: ModelConfig) -> Tuple[int, int]:
    """(num_prologue, num_scanned) layers."""
    k = cfg.moe.first_k_dense if cfg.moe is not None else 0
    return k, cfg.num_layers - k


def decoder_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device):
    check_supported(cfg)
    n_pro, n_scan = _prologue_plan(cfg)
    kw = dict(dtype=dtype, device=device, cross=cfg.cross_attention)
    pro_ff = cfg.moe.first_dense_d_ff if cfg.moe is not None else 0
    return {"prologue": [_layer_init(gen, cfg, dense_override_ff=pro_ff,
                                     **kw) for _ in range(n_pro)],
            "layers": [_layer_init(gen, cfg, **kw) for _ in range(n_scan)]}


def _layer_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device, cross_src: int):
    """One layer's cache, slot axis 0."""
    if cfg.hybrid_parallel:
        c = {"attn": A.gqa_cache_init(cfg, batch, max_len, dtype, device),
             "ssm": S.mamba_cache_init(cfg, batch, dtype, device)}
    elif cfg.ssm is not None:
        c = {"ssm": S.mamba_cache_init(cfg, batch, dtype, device)}
    elif cfg.mla is not None:
        c = {"attn": A.mla_cache_init(cfg, batch, max_len, dtype, device)}
    else:
        c = {"attn": A.gqa_cache_init(cfg, batch, max_len, dtype, device)}
    if cross_src:
        c["cross"] = A.gqa_cache_init(cfg, batch, cross_src, dtype, device)
    return c


def decoder_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device, *, cross_src: int = 0):
    """cross_src: the cross cache's source capacity (enc-dec decoders)."""
    check_supported(cfg)
    n_pro, n_scan = _prologue_plan(cfg)
    pro = [_layer_cache_init(cfg, batch, max_len, dtype, device, cross_src)
           for _ in range(n_pro)]
    one = _layer_cache_init(cfg, batch, max_len, dtype, device, cross_src)
    scanned = {kind: {name: torch.zeros((n_scan,) + t.shape,
                                        dtype=t.dtype, device=device)
                      for name, t in leaves.items()}
               for kind, leaves in one.items()}
    return {"prologue": pro, "scanned": scanned,
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def _layers_and_caches(params, cache):
    """(params, cache) of every layer in order: the prologue's own, then
    each scanned layer's, its cache as views into the stacked tensors."""
    scanned = [{kind: {name: t[i] for name, t in leaves.items()}
                for kind, leaves in cache["scanned"].items()}
               for i in range(len(params["layers"]))]
    return zip(params["prologue"] + params["layers"],
               cache["prologue"] + scanned)


def cache_slot_axes(cache) -> PyTree:
    """Slot axis per cache leaf, -1 for leaves without one: the stacked
    (scanned) leaves carry the layer axis first, so their slot axis is 1;
    every other leaf is slot-leading."""
    def axis(leaf, scanned: bool):
        if isinstance(leaf, dict):
            return {k: axis(v, scanned) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [axis(v, scanned) for v in leaf]
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return -1
        return 1 if scanned else 0

    return {k: axis(v, k == "scanned") for k, v in cache.items()}


def _global(cfg: ModelConfig, i: int) -> bool:
    return i in cfg.global_attn_layers


def decoder_fwd(params, cfg: ModelConfig, x, positions, *,
                use_kernels: bool = True, moe_dispatch: str = "einsum",
                remat: bool = False):
    """Full-sequence causal decoder pass without a cache (training, and the
    embedding stacks of decoder-only archs): (x, aux), aux the MoE layers'
    load-balance losses summed over the prologue and the layers in order
    (fp32, 0 without MoE), as the reference's.  With ``remat`` and
    autograd recording, each layer is checkpointed (non-reentrant; the
    layer function returns both values): its backward recomputes the
    layer from its input, as the reference's scan body under
    ``jax.checkpoint(nothing_saveable)`` does."""
    def layer(lp, i, h):
        return _layer_fwd(lp, cfg, h, positions, causal=True,
                          is_global=_global(cfg, i), kv_len=None,
                          use_kernels=use_kernels, moe_dispatch=moe_dispatch)

    remat = remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["prologue"] + params["layers"]):
        if remat:
            x, aux = checkpoint(layer, lp, i, x, use_reentrant=False)
        else:
            x, aux = layer(lp, i, x)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def decoder_prefill(params, cfg: ModelConfig, x, positions, cache, *,
                    true_len=None, use_kernels: bool = True, enc_out=None,
                    src_len=None, moe_dispatch: str = "einsum"):
    """enc_out/src_len: the encoder output and its valid lengths, for the
    cross layers of an enc-dec decoder (src_len None: all of enc_out)."""
    for i, (lp, lc) in enumerate(_layers_and_caches(params, cache)):
        x, _ = _layer_prefill(lp, cfg, x, positions, lc,
                              is_global=_global(cfg, i),
                              use_kernels=use_kernels, enc_out=enc_out,
                              src_len=src_len, moe_dispatch=moe_dispatch)
    B, S = x.shape[0], x.shape[1]
    if true_len is None:
        pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        pos = torch.as_tensor(true_len, dtype=torch.int32,
                              device=x.device).expand(B).clone()
    return x, {"prologue": cache["prologue"], "scanned": cache["scanned"],
               "pos": pos}


def decoder_step(params, cfg: ModelConfig, x1, cache, *,
                 use_kernels: bool = False, kv_bound: Optional[int] = None,
                 live=None, src_len=None, src_bound: Optional[int] = None,
                 moe_dispatch: str = "einsum"):
    """use_kernels/kv_bound/live: the ragged decode hot path (see
    ``attention.gqa_step``; MLA bounds its latent read the same way);
    src_len/src_bound: the cross-attention reads of an enc-dec decoder
    (``attention.cross_step``).  Positions advance in place, as the KV and
    state do: a captured step reads and writes the same tensors on every
    replay."""
    pos = cache["pos"]
    for i, (lp, lc) in enumerate(_layers_and_caches(params, cache)):
        x1, _ = _layer_step(lp, cfg, x1, lc, pos, is_global=_global(cfg, i),
                            use_kernels=use_kernels, kv_bound=kv_bound,
                            live=live, src_len=src_len, src_bound=src_bound,
                            moe_dispatch=moe_dispatch)
    pos.add_(1)
    return x1, cache


# ---------------------------------------------------------------------------
# encoder (bidirectional, enc-dec)
# ---------------------------------------------------------------------------

def encoder_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device):
    return {"layers": [_layer_init(gen, cfg, dtype=dtype, device=device)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": norm_init(cfg.norm, cfg.d_model, device)}


def encoder_fwd(params, cfg: ModelConfig, x, positions, *, kv_len=None,
                use_kernels: bool = True):
    """Bidirectional encoder stack.  kv_len: optional (B,) int32 valid
    lengths of right-padded rows; each row's attention masks its own key
    padding, so the valid rows of the output do not depend on the padded
    length (None: every row is all valid)."""
    for lp in params["layers"]:
        x, _ = _layer_fwd(lp, cfg, x, positions, causal=False,
                          is_global=False, kv_len=kv_len,
                          use_kernels=use_kernels)
    return L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent_chunk(xb, w_head, lb, mb, logit_softcap: float):
    """Summed masked NLL of one sequence chunk: logits in the activation
    dtype, then fp32; the gold logit by a gather (the reference's one-hot
    contraction picks the same value)."""
    logits = (xb @ w_head.to(xb.dtype)).float()
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mb)


def chunked_softmax_xent(x, w_head, labels, mask, *, chunk: int = 512,
                         logit_softcap: float = 0.0):
    """Mean cross-entropy over a huge vocabulary without materializing
    (B, S, V): x (B, S, d), w_head (d, V), labels and mask (B, S).  Only
    one chunk's (B, chunk, V) logits exist at a time; under autograd each
    chunk is checkpointed, so the backward recomputes its logits instead
    of keeping them (about 2.1 GB per chunk of fp32 logits at vocab 256000
    and B 4), as the reference checkpoints its scan body."""
    S = x.shape[1]
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (x[:, c0:c0 + chunk], w_head, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], logit_softcap)
        tot = tot + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                     if remat else _xent_chunk(*args))
    return tot / torch.clamp(mask.sum(), min=1.0)
