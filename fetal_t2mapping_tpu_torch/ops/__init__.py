from .morphology import (
    binary_dilate,
    binary_erode,
    binary_closing,
    binary_opening,
    build_slice_mask,
    fill_holes,
)
from .interp import sample_trilinear, sample_nearest
from .tv import tv_denoise_slices

__all__ = [
    "binary_dilate",
    "binary_erode",
    "binary_closing",
    "binary_opening",
    "build_slice_mask",
    "fill_holes",
    "sample_trilinear",
    "sample_nearest",
    "tv_denoise_slices",
]
