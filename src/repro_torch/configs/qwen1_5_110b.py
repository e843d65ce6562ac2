"""qwen1.5-110b — large dense with QKV bias [hf:Qwen/Qwen1.5 family].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
Largest dense arch in the pool; training uses factored optimizer state
(adafactor) to fit 256 v5e chips (DESIGN.md §6.4).

In the port only REDUCED runs: the full model's ~111B parameters (about
207 GiB in bf16) do not fit one 80 GB H100, so its serving waits for more
cards.  REDUCED exercises the QKV bias of the dense decoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    attn_type="full",
    qkv_bias=True,
    act="silu",
    glu=True,
    optimizer="adafactor",
)

REDUCED = ModelConfig(
    name="qwen1.5-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    qkv_bias=True,
    act="silu",
    glu=True,
)
