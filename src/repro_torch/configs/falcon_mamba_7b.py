"""falcon-mamba-7b — attention-free Mamba-1 [arXiv:2410.05355].

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16.
Pure Mamba-1 blocks: the mixer *is* the FFN (d_inner = 2*d_model), so d_ff=0.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    attn_type="none",
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    act="silu",
    glu=False,
)

REDUCED = ModelConfig(
    name="falcon-mamba-reduced",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    attn_type="none",
    ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
    act="silu",
    glu=False,
)
