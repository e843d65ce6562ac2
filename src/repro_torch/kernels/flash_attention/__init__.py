from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_lse",
           "flash_attention_bwd_ref", "flash_attention_lse_ref",
           "flash_attention_ref"]
