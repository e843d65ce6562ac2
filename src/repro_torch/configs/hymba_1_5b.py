"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer computes attention and a Mamba head in parallel on the same input
and fuses the two normalized outputs (Hymba §2.1).  Attention is sliding-window
except for 3 global layers (first / middle / last), which keeps `long_500k`
sub-quadratic (DESIGN.md §4).

In the port the full model serves on one H100 through ``DecodeEngine``:
the sliding-window and global flash and ragged decode kernels beside the
Mamba scan and step, in every layer.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    attn_type="sliding",
    window_size=1024,
    global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    hybrid_parallel=True,
    act="silu",
    glu=True,
)

REDUCED = ModelConfig(
    name="hymba-reduced",
    family="hybrid",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    attn_type="sliding",
    window_size=8,
    global_attn_layers=(0,),
    ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
    hybrid_parallel=True,
    act="silu",
    glu=True,
)
