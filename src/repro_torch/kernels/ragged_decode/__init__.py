from repro_torch.kernels.ragged_decode.ops import ragged_decode_attention
from repro_torch.kernels.ragged_decode.ref import ragged_decode_attention_ref

__all__ = ["ragged_decode_attention", "ragged_decode_attention_ref"]
