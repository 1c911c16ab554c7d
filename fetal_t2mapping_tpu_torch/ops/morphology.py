"""Binary morphology (dilation / erosion / closing / opening / fill-holes).

The counterpart of ``fetal_t2mapping_tpu.ops.morphology``, replacing the
SimpleITK/scipy.ndimage morphology of the reference's masks and phantom
labels (reference utils/qmri_utils.py:223-252, 591-623, 868-951):

- box (cube) elements: separable max/min pooling with zero padding;
- ball (Euclidean) elements: the count of set voxels in the ball by FFT
  convolution, thresholded at 0.5 (the counts are near-integers);
- hole filling: a border-seeded 6-connected flood fill of the background,
  iterated to its fixed point, then inverted (scipy's
  binary_fill_holes with the default structure).

Every function takes and returns bool tensors and runs on the tensor's
device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# fill_holes reads "did anything change" from the card every this many
# flood-fill steps: the fill is idempotent at its fixed point, so extra
# steps change nothing
_FILL_CHECK_EVERY = 16


def _as_bool3d(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.ndim != 3:
        raise ValueError(f"expected 3-D mask, got shape {tuple(x.shape)}")
    return x.bool()


def _box_pool(x_bool: torch.Tensor, radius: int, is_max: bool,
              axes: Sequence[int] = (0, 1, 2)) -> torch.Tensor:
    """Separable (2r+1)^d max/min pooling along ``axes``, out-of-volume =
    background (zero padding, scipy's border_value=0). Size-1 axes are
    left out: a (z, y, 1) slab is a 2-D slice."""
    active = [a for a in axes if x_bool.shape[a] > 1]
    pad = [0] * 6
    for a in active:
        pad[2 * (2 - a)] = pad[2 * (2 - a) + 1] = radius
    x = F.pad(x_bool.to(torch.float32), pad)
    if not is_max:
        x = -x
    k = 2 * radius + 1
    for a in active:
        kernel = [1, 1, 1]
        kernel[a] = k
        x = F.max_pool3d(x[None, None], kernel, stride=1)[0, 0]
    return (x > 0.5) if is_max else (x < -0.5)


def _ball_kernel(radius: int) -> np.ndarray:
    r = int(radius)
    g = np.arange(-r, r + 1)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    return (zz * zz + yy * yy + xx * xx <= r * r).astype(np.float32)


def _ball_conv_count(x_bool: torch.Tensor, radius: int) -> torch.Tensor:
    """Count of set voxels within the ball around each voxel (FFT conv)."""
    shape = tuple(x_bool.shape)
    pad = radius
    padded = tuple(s + 2 * pad for s in shape)
    x = F.pad(x_bool.to(torch.float32), [pad] * 6)
    kf = torch.zeros(padded, dtype=torch.float32, device=x_bool.device)
    kf[:2 * pad + 1, :2 * pad + 1, :2 * pad + 1] = torch.from_numpy(_ball_kernel(radius))
    kf = torch.roll(kf, shifts=(-pad, -pad, -pad), dims=(0, 1, 2))
    conv = torch.fft.irfftn(torch.fft.rfftn(x) * torch.fft.rfftn(kf), s=padded)
    return conv[pad:pad + shape[0], pad:pad + shape[1], pad:pad + shape[2]]


def binary_dilate(mask, radius: int = 1, *, box: bool = False, iterations: int = 1):
    """Dilate a binary mask with a ball (default, SimpleITK semantics) or box."""
    m = _as_bool3d(mask)
    for _ in range(iterations):
        m = _box_pool(m, radius, True) if box else _ball_conv_count(m, radius) > 0.5
    return m


def binary_erode(mask, radius: int = 1, *, box: bool = False, iterations: int = 1):
    """Erode a binary mask with a ball or box structuring element."""
    m = _as_bool3d(mask)
    for _ in range(iterations):
        if box:
            m = _box_pool(m, radius, False)
        else:
            ker_sum = float(_ball_kernel(radius).sum())
            m = _ball_conv_count(m, radius) > ker_sum - 0.5
    return m


def binary_closing(mask, radius: int = 1, *, box: bool = False):
    return binary_erode(binary_dilate(mask, radius, box=box), radius, box=box)


def binary_opening(mask, radius: int = 1, *, box: bool = False):
    return binary_dilate(binary_erode(mask, radius, box=box), radius, box=box)


def _dilate_cross(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """One cross-shaped dilation step along ``axes`` (6-connected in 3-D)."""
    out = x.clone()
    for a in axes:
        n = x.shape[a]
        if n > 1:
            out.narrow(a, 1, n - 1).logical_or_(x.narrow(a, 0, n - 1))
            out.narrow(a, 0, n - 1).logical_or_(x.narrow(a, 1, n - 1))
    return out


def _fill_holes(m: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """Fill cavities not connected to the border along ``axes``."""
    outside = ~m
    # seed: background voxels on the faces of the connected axes. Size-1
    # axes are left out: seeding their "faces" (the slab itself) would mark
    # every cavity as outside
    seed = torch.zeros_like(m)
    for a in axes:
        if m.shape[a] > 1:
            seed.narrow(a, 0, 1).fill_(True)
            seed.narrow(a, m.shape[a] - 1, 1).fill_(True)
    reach = seed & outside
    while True:
        before = reach
        for _ in range(_FILL_CHECK_EVERY):
            reach = _dilate_cross(reach, axes) & outside
        if torch.equal(reach, before):
            break
    return m | (outside & ~reach)


def fill_holes(mask) -> torch.Tensor:
    """Fill cavities not connected to the volume border (6-connectivity)."""
    return _fill_holes(_as_bool3d(mask), (0, 1, 2))


def build_slice_mask(image: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """Per-slice signal mask: threshold, fill holes, 5x5 dilate then erode.

    The reference's registration masking helper (utils/qmri_utils.py:
    223-252) iterates 2-D slices along the last array axis: the slices here
    are the (z, y) planes indexed by x, all filled and pooled at once by
    working along axes 0 and 1 only."""
    bw = torch.as_tensor(image) > threshold
    m = _fill_holes(bw, (0, 1))
    m = _box_pool(m, 2, True, axes=(0, 1))
    return _box_pool(m, 2, False, axes=(0, 1))
