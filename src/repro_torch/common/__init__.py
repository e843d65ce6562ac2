from repro_torch.common.platform import (PROFILES, VCK190, PlatformProfile,
                                         get_profile)

__all__ = ["PROFILES", "VCK190", "PlatformProfile", "get_profile"]
