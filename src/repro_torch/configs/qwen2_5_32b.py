"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    attn_type="full",
    qkv_bias=True,
    act="silu",
    glu=True,
)

REDUCED = ModelConfig(
    name="qwen2.5-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    qkv_bias=True,
    act="silu",
    glu=True,
)
