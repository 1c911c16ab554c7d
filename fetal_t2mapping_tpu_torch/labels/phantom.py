"""NIST phantom sphere labels from seed voxels.

The counterpart of ``fetal_t2mapping_tpu.labels.phantom``. The reference
writes a 1 at each seed voxel, ball-dilates by radius 6, fills holes and
max-accumulates the labels (utils/qmri_utils.py:868-933). Dilating a single
seed by a ball IS the ball, so each sphere is {voxel : ||voxel - seed||_2
<= r} in index space, exact, evaluated on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.volume import Volume
from ..device import resolve_device


def phantom_labels_from_seeds(geometry: Volume, seeds_xyz: Sequence[Sequence[int]],
                              radius: int = 6, device="cuda") -> Volume:
    """Label map with sphere i+1 centred at seeds_xyz[i] (x, y, z order),
    computed on ``device``; returns host uint8 data. Later seeds win on
    overlap by max-accumulation, as the reference's sitk.Maximum fold."""
    nz, ny, nx = geometry.shape
    seeds = np.asarray(seeds_xyz, np.int64)
    if seeds.ndim != 2 or seeds.shape[1] != 3:
        raise ValueError("seeds must be (n, 3) in (x, y, z) order")
    dev = resolve_device(device)
    zz = torch.arange(nz, device=dev)[:, None, None]
    yy = torch.arange(ny, device=dev)[None, :, None]
    xx = torch.arange(nx, device=dev)[None, None, :]
    acc = torch.zeros((nz, ny, nx), dtype=torch.uint8, device=dev)
    for label, (sx, sy, sz) in enumerate(seeds.tolist(), start=1):
        sphere = (zz - sz) ** 2 + (yy - sy) ** 2 + (xx - sx) ** 2 <= radius * radius
        acc = torch.maximum(acc, sphere.to(torch.uint8) * label)
    return geometry.with_data(acc.cpu().numpy())
