"""Model configuration schema (the port's own copy of ``repro.configs.base``).

Field for field the same dataclasses as the JAX package, so a test can hold
the two against each other with ``dataclasses.asdict``.  The one framework
touch point, ``activation_dtype``, returns a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype."""
    if name not in _DTYPES:
        raise KeyError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0              # d_ff of each shared expert (0 -> expert_d_ff)
    dense_residual: bool = False      # Arctic: dense FFN in parallel with MoE
    dense_residual_d_ff: int = 0
    first_k_dense: int = 0            # DeepSeek: first k layers use dense FFN
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    group_size: int = 1024


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 -> full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    dt_rank: int = 0                  # 0 -> ceil(d_model / 16)
    d_inner: int = 0                  # 0 -> expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    # attention
    attn_type: str = "full"            # full | sliding | none
    window_size: int = 1024
    global_attn_layers: Tuple[int, ...] = ()   # layers forced to full attn
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # submodules
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_parallel: bool = False
    # encoder-decoder
    encoder_layers: int = 0
    encoder_bidirectional: bool = True
    cross_attention: bool = False
    frontend: str = "tokens"
    # misc
    act: str = "silu"                  # silu | gelu | relu | relu2
    glu: bool = True
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    optimizer: str = "adamw"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX package's layout of
        the embedding and LM head, kept so weights bridge unchanged)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.attn_type == "none"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM or sliding-window everywhere)."""
        if self.ssm is not None and (self.attn_type == "none"
                                     or self.hybrid_parallel):
            return True
        return self.attn_type == "sliding"

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer weights)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn_type != "none" and not self.hybrid_parallel:
            if self.mla is not None:
                m = self.mla
                qdim = nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * (m.q_lora_rank or 0) or 0
                per_layer += (m.q_lora_rank or d) * qdim if m.q_lora_rank else d * qdim
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                per_layer += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                per_layer += nq * m.v_head_dim * d
            else:
                per_layer += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.hybrid_parallel:
            per_layer += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.ssm is not None:
            s = self.ssm
            d_in = s.d_inner or s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            per_layer += d * 2 * d_in
            per_layer += d_in * s.conv_width
            per_layer += d_in * (dt_rank + 2 * s.state_dim)
            per_layer += dt_rank * d_in
            per_layer += d_in * s.state_dim + 2 * d_in
            per_layer += d_in * d
        ffn_mult = 3 if self.glu else 2
        dense_correction = 0
        if self.moe is None:
            if self.d_ff:
                per_layer += ffn_mult * d * self.d_ff
        else:
            mo = self.moe
            per_layer += d * mo.num_experts
            per_layer += mo.num_experts * ffn_mult * d * mo.expert_d_ff
            if mo.num_shared_experts:
                per_layer += mo.num_shared_experts * ffn_mult * d * (
                    mo.shared_d_ff or mo.expert_d_ff)
            if mo.dense_residual:
                per_layer += ffn_mult * d * (mo.dense_residual_d_ff or self.d_ff)
            if mo.first_k_dense:
                moe_ffn = (d * mo.num_experts
                           + mo.num_experts * ffn_mult * d * mo.expert_d_ff
                           + mo.num_shared_experts * ffn_mult * d
                           * (mo.shared_d_ff or mo.expert_d_ff))
                dense_ffn = ffn_mult * d * (mo.first_dense_d_ff or self.d_ff)
                dense_correction = mo.first_k_dense * (dense_ffn - moe_ffn)
        total = emb + self.num_layers * per_layer + dense_correction
        if self.encoder_layers:
            total += self.encoder_layers * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d
                                            + ffn_mult * d * self.d_ff)
            total += self.num_layers * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        ffn_mult = 3 if self.glu else 2
        per_expert = ffn_mult * self.d_model * mo.expert_d_ff
        routed_all = self.num_layers * mo.num_experts * per_expert
        routed_active = self.num_layers * mo.top_k * per_expert
        return self.param_count() - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    # decode/long cells: kv_len = seq_len (cache length), one new token.


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

ALL_CELLS = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
CELLS_BY_NAME = {c.name: c for c in ALL_CELLS}


def cells_for(config: ModelConfig) -> Tuple[ShapeCell, ...]:
    """The shape cells an architecture runs: long_500k only for the
    sub-quadratic archs (``supports_long_context``)."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.supports_long_context:
        cells.append(LONG_500K)
    return tuple(cells)
