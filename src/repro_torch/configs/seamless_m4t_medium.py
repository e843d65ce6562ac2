"""seamless-m4t-medium — encoder-decoder multimodal backbone [arXiv:2308.11596].

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  We model the text/unit
transformer backbone: 12 bidirectional encoder layers + 12 causal decoder
layers with cross-attention.  The audio frontend is a STUB per assignment:
``input_specs()`` provides precomputed frame embeddings (B, S_src, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,               # decoder layers
    encoder_layers=12,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    attn_type="full",
    frontend="frames",
    act="gelu",
    glu=False,
    norm="layernorm",
)

REDUCED = ModelConfig(
    name="seamless-reduced",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    cross_attention=True,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    frontend="frames",
    act="gelu",
    glu=False,
    norm="layernorm",
)
