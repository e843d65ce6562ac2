from repro_torch.optim.base import (AdafactorConfig, AdamWConfig, Optimizer,
                                    adafactor, adamw, clip_by_global_norm,
                                    cosine_schedule, global_norm,
                                    make_optimizer, tree_leaves, tree_map)

__all__ = ["AdafactorConfig", "AdamWConfig", "Optimizer", "adafactor",
           "adamw", "clip_by_global_norm", "cosine_schedule", "global_norm",
           "make_optimizer", "tree_leaves", "tree_map"]
