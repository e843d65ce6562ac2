from repro_torch.optim.base import (AdafactorConfig, AdamWConfig, Optimizer,
                                    adafactor, adamw, clip_by_global_norm,
                                    cosine_schedule, global_norm,
                                    make_optimizer, tree_leaves, tree_map)
from repro_torch.optim.compression import (ErrorFeedback, compressed_psum,
                                           dequantize_int8, quantize_int8)

__all__ = ["AdafactorConfig", "AdamWConfig", "ErrorFeedback", "Optimizer",
           "adafactor", "adamw", "clip_by_global_norm", "compressed_psum",
           "cosine_schedule", "dequantize_int8", "global_norm",
           "make_optimizer", "quantize_int8", "tree_leaves", "tree_map"]
