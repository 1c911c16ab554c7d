"""Separable Gaussian filtering (the registration pyramids).

The counterpart of ``fetal_t2mapping_tpu.ops.filtering``. Each axis is a
zero-padded 1-D correlation written as a sum of shifted slices, so the card
and the CPU run the same elementwise arithmetic (no convolution library,
and so no TF32).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    if sigma <= 0:
        return np.array([1.0], np.float32)
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d_along(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    r = (k.shape[0] - 1) // 2
    n = x.shape[axis]
    pad = [0, 0] * 3
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r    # F.pad lists the last axis first
    xp = torch.nn.functional.pad(x, pad)
    out = xp.narrow(axis, 0, n) * float(k[0])
    for j in range(1, k.shape[0]):
        out = out + xp.narrow(axis, j, n) * float(k[j])
    return out


def gaussian_smooth3d(data: torch.Tensor,
                      sigma: Union[float, Sequence[float]]) -> torch.Tensor:
    """Separable Gaussian smoothing along the three axes; ``sigma`` is a
    scalar or per-axis tuple in voxels (zero disables an axis)."""
    x = data.to(torch.float32)
    sigmas = (sigma,) * 3 if np.isscalar(sigma) else tuple(sigma)
    for axis, sg in enumerate(sigmas):
        if sg > 0:
            x = _conv1d_along(x, gaussian_kernel1d(float(sg)), axis)
    return x


def smooth_subsample(data: torch.Tensor, sigma: float, factor: int) -> torch.Tensor:
    """Gaussian smoothing + strided subsampling (one image-pyramid level)."""
    x = gaussian_smooth3d(data, float(sigma))
    if factor > 1:
        x = x[::factor, ::factor, ::factor].contiguous()
    return x
