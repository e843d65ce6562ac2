"""granite-34b — deep/narrow dense code model, MQA [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1 — multi-query) d_ff=24576 vocab=49152.
MQA means the KV cache cannot shard over heads: decode shards KV over the
*sequence* dim (flash-decoding split-K over the model axis), DESIGN.md §6.3.

In the port the full model (about 68 GB in bf16) serves on one H100: its
48 query heads per KV head take the ragged decode kernel's head groups.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    attn_type="full",
    act="gelu",
    glu=False,
)

REDUCED = ModelConfig(
    name="granite-reduced",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    act="gelu",
    glu=False,
)
