"""minitron-4b — pruned Nemotron dense model [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Squared-ReLU MLP (Nemotron family), no GLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    attn_type="full",
    act="relu2",
    glu=False,
)

REDUCED = ModelConfig(
    name="minitron-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    act="relu2",
    glu=False,
)
