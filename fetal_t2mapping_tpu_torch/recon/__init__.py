from .resample import resample_volume, resample_to_reference
from .registration import (register_rigid, register_affine,
                           register_rigid_multi, register_affine_multi,
                           register_and_resample)
from .fuse import fuse_orientations
from .denoise import denoise_volume
from .biasfield import n4_bias_correction, shared_log_bias

__all__ = [
    "resample_volume",
    "resample_to_reference",
    "register_rigid",
    "register_affine",
    "register_rigid_multi",
    "register_affine_multi",
    "register_and_resample",
    "fuse_orientations",
    "denoise_volume",
    "n4_bias_correction",
    "shared_log_bias",
]
