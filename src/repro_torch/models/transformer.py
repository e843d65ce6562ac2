"""Transformer stacks of the port (``repro.models.transformer``): dense GQA
and attention-free Mamba decoders, and the encoder-decoder's
bidirectional encoder and cross-attending decoder.

The reference scans one stacked layer body with ``lax.scan``; here a
Python loop runs over a list of per-layer parameter dicts.  The decode
cache keeps the reference's structure, ``{"prologue": [], "scanned":
{"attn": {"k", "v"}} or {"ssm": {"conv", "h"}}, "pos"}``, with stacked
leaves (layer axis 0, slot axis 1: KV (L, B, T, Hkv, D), conv window (L,
B, w-1, d_in), state (L, B, d_in, N) fp32) updated IN PLACE layer by
layer.  An enc-dec decoder's cache adds ``scanned["cross"] = {"k", "v"}``
(L, B, max_src, Hkv, D), the reference's per-layer ``cross_k`` and
``cross_v``.

MoE, MLA and hybrid (attention beside SSM) stacks raise
``NotImplementedError``: they belong to later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

PyTree = Any


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the stacks the port does not cover yet: it serves dense
    GQA decoders, attention-free SSM (Mamba) decoders and dense GQA
    encoder-decoders."""
    later = [("moe", cfg.moe is not None, "the MLA/MoE slice"),
             ("mla", cfg.mla is not None, "the MLA/MoE slice"),
             ("hybrid_parallel", cfg.hybrid_parallel, "the hybrid SSM slice"),
             ("ssm beside attention",
              cfg.ssm is not None and not cfg.attention_free,
              "the hybrid SSM slice"),
             ("ssm encoder", cfg.is_encdec and cfg.ssm is not None,
              "no slice: the reference's enc-dec archs are dense")]
    for field, present, where in later:
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {field} is not ported yet; it belongs to "
                f"{where} of the PyTorch port")


def norm_init(kind: str, dim: int, device) -> Dict[str, torch.Tensor]:
    """Norm parameters stay fp32: the norms compute in fp32."""
    p = {"scale": torch.ones(dim, dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(dim, dtype=torch.float32, device=device)
    return p


def _layer_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device,
                cross: bool = False):
    """One layer; ``cross`` adds cross-attention (enc-dec decoder)."""
    p: Dict[str, PyTree] = {"ln1": norm_init(cfg.norm, cfg.d_model, device)}
    if cfg.ssm is not None:
        p["ssm"] = S.mamba_init(gen, cfg, dtype=dtype, device=device)
    else:
        p["attn"] = A.gqa_init(gen, cfg, dtype=dtype, device=device)
    if cross:
        p["ln_cross"] = norm_init(cfg.norm, cfg.d_model, device)
        p["cross"] = A.cross_init(gen, cfg, dtype=dtype, device=device)
    if cfg.d_ff:
        p["ln2"] = norm_init(cfg.norm, cfg.d_model, device)
        p["ffn"] = M.ffn_init(gen, cfg, cfg.d_ff, dtype=dtype, device=device)
    return p


def _ffn(p, cfg: ModelConfig, x):
    if "ffn" in p:
        h2 = L.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
        x = x + M.ffn_apply(p["ffn"], cfg, h2)
    return x


def _layer_fwd(p, cfg: ModelConfig, x, positions, *, causal: bool,
               is_global: bool, kv_len, use_kernels: bool):
    """Residual layer without a cache (encoders, embedding stacks).  An SSM
    layer folds the sequence from a zero state, as its prefill does."""
    h = L.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if "ssm" in p:
        scratch = S.mamba_cache_init(cfg, x.shape[0], x.dtype, x.device)
        y, _ = S.mamba_prefill(p["ssm"], cfg, h, scratch,
                               use_kernels=use_kernels)
    else:
        y = A.gqa_fwd(p["attn"], cfg, h, positions, causal=causal,
                      is_global=is_global, kv_len=kv_len,
                      use_kernels=use_kernels)
    return _ffn(p, cfg, x + y)


def _cross(p, cfg: ModelConfig, x, fn):
    """The cross-attention sublayer, when the layer has one."""
    if "cross" not in p:
        return x
    hc = L.apply_norm(cfg.norm, p["ln_cross"], x, cfg.norm_eps)
    return x + fn(hc)


def _layer_prefill(p, cfg: ModelConfig, x, positions, cache, *,
                   is_global: bool, use_kernels: bool, enc_out=None,
                   src_len=None):
    h = L.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if "ssm" in p:
        y, cache["ssm"] = S.mamba_prefill(p["ssm"], cfg, h, cache["ssm"],
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
    return _ffn(p, cfg, x), cache


def _layer_step(p, cfg: ModelConfig, x1, cache, pos, *, is_global: bool,
                use_kernels: bool, kv_bound: Optional[int], live,
                src_len=None, src_bound: Optional[int] = None):
    h = L.apply_norm(cfg.norm, p["ln1"], x1, cfg.norm_eps)
    if "ssm" in p:
        y, cache["ssm"] = S.mamba_step(p["ssm"], cfg, h, cache["ssm"],
                                       use_kernels=use_kernels, live=live)
    else:
        y, cache["attn"] = A.gqa_step(p["attn"], cfg, h, cache["attn"], pos,
                                      is_global=is_global,
                                      use_kernels=use_kernels,
                                      kv_bound=kv_bound, live=live)
    x1 = _cross(p, cfg, x1 + y, lambda hc: A.cross_step(
        p["cross"], cfg, hc, cache["cross"]["k"], cache["cross"]["v"],
        src_len, use_kernels=use_kernels, src_bound=src_bound, live=live))
    return _ffn(p, cfg, x1), cache


def decoder_init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device):
    check_supported(cfg)
    return {"layers": [_layer_init(gen, cfg, dtype=dtype, device=device,
                                   cross=cfg.cross_attention)
                       for _ in range(cfg.num_layers)]}


def decoder_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device, *, cross_src: int = 0):
    """cross_src: the cross cache's source capacity (enc-dec decoders)."""
    check_supported(cfg)
    if cfg.ssm is not None:
        kinds = {"ssm": S.mamba_cache_init(cfg, batch, dtype, device)}
    else:
        kinds = {"attn": A.gqa_cache_init(cfg, batch, max_len, dtype,
                                          device)}
    if cross_src:
        kinds["cross"] = A.gqa_cache_init(cfg, batch, cross_src, dtype,
                                          device)
    scanned = {kind: {name: torch.zeros((cfg.num_layers,) + t.shape,
                                        dtype=t.dtype, device=device)
                      for name, t in one.items()}
               for kind, one in kinds.items()}
    return {"prologue": [], "scanned": scanned,
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def _layer_cache(cache, i: int):
    """Layer ``i``'s cache as views into the stacked tensors."""
    return {kind: {name: t[i] for name, t in leaves.items()}
            for kind, leaves in cache["scanned"].items()}


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
                use_kernels: bool = True):
    """Full-sequence causal decoder pass without a cache (the embedding
    stacks of decoder-only archs)."""
    for i, lp in enumerate(params["layers"]):
        x = _layer_fwd(lp, cfg, x, positions, causal=True,
                       is_global=_global(cfg, i), kv_len=None,
                       use_kernels=use_kernels)
    return x


def decoder_prefill(params, cfg: ModelConfig, x, positions, cache, *,
                    true_len=None, use_kernels: bool = True, enc_out=None,
                    src_len=None):
    """enc_out/src_len: the encoder output and its valid lengths, for the
    cross layers of an enc-dec decoder (src_len None: all of enc_out)."""
    layers: List = params["layers"]
    for i, lp in enumerate(layers):
        x, _ = _layer_prefill(lp, cfg, x, positions, _layer_cache(cache, i),
                              is_global=_global(cfg, i),
                              use_kernels=use_kernels, enc_out=enc_out,
                              src_len=src_len)
    B, S = x.shape[0], x.shape[1]
    if true_len is None:
        pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        pos = torch.as_tensor(true_len, dtype=torch.int32,
                              device=x.device).expand(B).clone()
    return x, {"prologue": [], "scanned": cache["scanned"], "pos": pos}


def decoder_step(params, cfg: ModelConfig, x1, cache, *,
                 use_kernels: bool = False, kv_bound: Optional[int] = None,
                 live=None, src_len=None, src_bound: Optional[int] = None):
    """use_kernels/kv_bound/live: the ragged decode hot path (see
    ``attention.gqa_step``); src_len/src_bound: the cross-attention reads
    of an enc-dec decoder (``attention.cross_step``).  Positions advance in
    place, as the KV and state do: a captured step reads and writes the
    same tensors on every replay."""
    pos = cache["pos"]
    for i, lp in enumerate(params["layers"]):
        x1, _ = _layer_step(lp, cfg, x1, _layer_cache(cache, i), pos,
                            is_global=_global(cfg, i),
                            use_kernels=use_kernels, kv_bound=kv_bound,
                            live=live, src_len=src_len, src_bound=src_bound)
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
        x = _layer_fwd(lp, cfg, x, positions, causal=False, is_global=False,
                       kv_len=kv_len, use_kernels=use_kernels)
    return L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
