from repro_torch.kernels.filco_mm.ops import (atoms_issued_flexible,
                                              atoms_issued_static, flex_mm,
                                              static_mm)
from repro_torch.kernels.filco_mm.ref import flex_mm_ref, static_mm_ref

__all__ = ["atoms_issued_flexible", "atoms_issued_static", "flex_mm",
           "flex_mm_ref", "static_mm", "static_mm_ref"]
