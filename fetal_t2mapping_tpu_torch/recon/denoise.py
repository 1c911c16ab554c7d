"""Volume-level TV denoising (reference utils/qmri_utils.py:393-405); the
counterpart of ``fetal_t2mapping_tpu.recon.denoise``."""

from __future__ import annotations

import torch

from ..core.volume import Volume
from ..device import resolve_device
from ..ops.tv import tv_denoise_slices
from .resample import to_tensor


def denoise_volume(vol: Volume, weight: float = 0.1, eps: float = 2e-4,
                   max_iter: int = 200, device="cuda") -> Volume:
    """Slice-wise TV-Chambolle denoising on ``device``, geometry preserved.
    Returns a Volume whose data is a float32 tensor on ``device``."""
    data = to_tensor(vol.data, resolve_device(device), torch.float32)
    return vol.with_data(tv_denoise_slices(data, weight, eps, max_iter))
