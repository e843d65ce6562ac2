"""The kernel wrappers' launch counters, by kernel name.  Each wrapper adds
one to its module's counter where it launches its kernel; a CUDA graph's
replay adds the launches its capture recorded
(``repro_torch.workloads.compile_cache.GraphStep``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.filco_mm import ops as _fm
from repro_torch.kernels.flash_attention import ops as _fa
from repro_torch.kernels.mamba_scan import ops as _ms
from repro_torch.kernels.ragged_decode import ops as _rd

# kernel name -> (wrapper module, counter attribute)
COUNTERS = {"ragged_decode": (_rd, "launches"),
            "flash_attention": (_fa, "launches"),
            "flash_attention_kv_len": (_fa, "masked_launches"),
            "flash_attention_d192": (_fa, "d192_launches"),
            "flash_attention_d256": (_fa, "d256_launches"),
            "flash_attention_lse": (_fa, "lse_launches"),
            "flash_attention_lse_d192": (_fa, "lse_d192_launches"),
            "flash_attention_bwd": (_fa, "bwd_launches"),
            "flash_attention_bwd_d192": (_fa, "bwd_d192_launches"),
            "flash_attention_lse_window": (_fa, "lse_window_launches"),
            "flash_attention_bwd_window": (_fa, "bwd_window_launches"),
            "mamba_step": (_ms, "step_launches"),
            "mamba_scan": (_ms, "scan_launches"),
            "mamba_scan_train": (_ms, "scan_train_launches"),
            "mamba_scan_bwd": (_ms, "scan_bwd_launches"),
            "flex_mm": (_fm, "launches"),
            "static_mm": (_fm, "static_launches")}


def counts() -> Dict[str, int]:
    """Every counter's value now."""
    return {name: getattr(mod, attr) for name, (mod, attr)
            in COUNTERS.items()}


def add(delta: Dict[str, int]) -> None:
    """Add ``delta`` to the counters, by kernel name."""
    for name, n in delta.items():
        mod, attr = COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)
