"""arctic-480b — dense-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864, vocab=32000; MoE 128 experts top-2
**in parallel with a dense residual FFN** (Arctic's dense+MoE hybrid: the MoE
branch is added residually alongside a dense MLP).  ~480B total / ~17B active.
Optimizer: factored second moment (adafactor) — see DESIGN.md §6.4; a full
fp32 AdamW state for 480B params does not fit 256 v5e chips.

In the port only REDUCED runs: the full model's ~480B parameters (about
960 GB in bf16) do not fit one 80 GB H100, so its serving waits for more
cards.  REDUCED exercises the MoE layer's dense-residual branch.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    attn_type="full",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_d_ff=4864,
        dense_residual=True,
        dense_residual_d_ff=4864,
        capacity_factor=1.25,
    ),
    act="silu",
    glu=True,
    optimizer="adafactor",
    param_dtype="bfloat16",   # 477B fp32 master weights exceed 256x16GiB HBM
)

REDUCED = ModelConfig(
    name="arctic-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    moe=MoEConfig(
        num_experts=4,
        top_k=2,
        expert_d_ff=96,
        dense_residual=True,
        dense_residual_d_ff=96,
        # E/top_k => capacity == group length: no token drops, so decode
        # exactly matches prefill in consistency tests.
        capacity_factor=2.0,
    ),
    act="silu",
    glu=True,
)
