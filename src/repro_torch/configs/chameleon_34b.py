"""chameleon-34b — early-fusion VLM [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Early fusion: VQ-GAN
image codes live *inside* the text vocabulary, so the backbone consumes one
mixed token stream; the image tokenizer frontend is a STUB per assignment
(``input_specs()`` provides token ids that include image-token spans).
Chameleon stabilizes training with QK-norm — modeled here.

In the port the full model (about 63.9 GB in bf16) would fit one H100, but
it runs no kernel shape that granite-34b and minitron-4b do not (8 query
heads per KV head, head dim 128), so only REDUCED runs, on the CPU, where
it exercises QK-norm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    attn_type="full",
    qk_norm=True,
    act="silu",
    glu=True,
)

REDUCED = ModelConfig(
    name="chameleon-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    attn_type="full",
    qk_norm=True,
    act="silu",
    glu=True,
)
