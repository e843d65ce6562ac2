from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_step
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref, mamba_step_ref

__all__ = ["mamba_scan", "mamba_scan_ref", "mamba_step", "mamba_step_ref"]
