from .patch_sampler import (FlexPatchSampler, FullImageSampler, RescalePatchSampler,
                            sample_image_patches)
from .ray_sampler import RaySampler, look_at_rotation

__all__ = ["FlexPatchSampler", "FullImageSampler", "RescalePatchSampler", "RaySampler",
           "look_at_rotation", "sample_image_patches"]
