"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H d_ff=1408 vocab=102400; MLA kv_lora_rank=512
(q: full-rank in the lite model), 64 routed experts top-6 + 2 shared experts;
first layer uses a dense FFN (d_ff=10944), as in the released model.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    attn_type="full",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_d_ff=1408,
        num_shared_experts=2,
        shared_d_ff=1408,
        first_k_dense=1,
        first_dense_d_ff=10944,
        capacity_factor=1.25,
    ),
    act="silu",
    glu=True,
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    mla=MLAConfig(
        kv_lora_rank=32,
        q_lora_rank=0,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    moe=MoEConfig(
        num_experts=4,
        top_k=2,
        expert_d_ff=64,
        num_shared_experts=1,
        shared_d_ff=64,
        first_k_dense=1,
        first_dense_d_ff=128,
        capacity_factor=2.0,   # E/top_k: drop-free for consistency tests
    ),
    act="silu",
    glu=True,
)
