from repro_torch.common.platform import (DEFAULT_CUS, H100_NVLINK, H100_SXM,
                                         PROFILES, VCK190, PlatformProfile,
                                         get_profile, per_cu)

__all__ = ["DEFAULT_CUS", "H100_NVLINK", "H100_SXM", "PROFILES", "VCK190",
           "PlatformProfile", "get_profile", "per_cu"]
