"""Multi-orientation HR volume fusion.

The counterpart of ``fetal_t2mapping_tpu.recon.fuse``, replacing the
reference's ``reconstruct_vol_trilinear`` (utils/qmri_utils.py:82-136):
register the two moving orientations onto the fixed one, resample all three
onto the fixed grid (direction-aware world-space trilinear), and average.
Everything stays on the device: each volume is uploaded once, the two
moving orientations solve in one multi-pair call, the warps are composed
from the device transforms, and only the caller downloads the fused volume.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.volume import Volume
from ..device import resolve_device
from .registration import register_rigid_multi
from .resample import resample_to_reference, to_tensor

ORIENTATIONS = ("ax", "cor", "sag")


def fuse_orientations(imgs: Dict[str, Volume], fixed_type: str = "ax", *,
                      weight_by_coverage: bool = True,
                      registration_kwargs: Optional[dict] = None,
                      device="cuda") -> Volume:
    """Fuse three orthogonal acquisitions into one HR volume on ``device``.

    Args:
        imgs: {'ax': Volume, 'cor': Volume, 'sag': Volume} (1 mm resampled).
        fixed_type: orientation used as the reference grid.
        weight_by_coverage: average only over volumes that cover a voxel
            (out-of-FOV samples excluded) instead of the reference's plain
            mean, which darkens voxels outside a moving volume's FOV.

    Returns a Volume whose data is a float32 tensor on ``device``.
    """
    missing = [o for o in ORIENTATIONS if o not in imgs]
    if missing:
        raise ValueError(f"missing orientations: {missing}")
    dev = resolve_device(device)
    fixed = imgs[fixed_type]
    fixed_dev = fixed.with_data(to_tensor(fixed.data, dev, torch.float32))
    movs = [imgs[o].with_data(to_tensor(imgs[o].data, dev, torch.float32))
            for o in ORIENTATIONS if o != fixed_type]
    regs = register_rigid_multi(fixed_dev, movs, device=dev, **(registration_kwargs or {}))
    warps = [resample_to_reference(mov, fixed, transform=reg.matrix_device, cval=np.nan,
                                   on_device=True, device=dev).data
             for mov, reg in zip(movs, regs)]
    return fixed.with_data(_fuse_combine(fixed_dev.data, warps,
                                         weight_by_coverage=weight_by_coverage))


def _fuse_combine(fixed_data: torch.Tensor, warps: Sequence[torch.Tensor], *,
                  weight_by_coverage: bool) -> torch.Tensor:
    """Validity-weighted average of the fixed volume and its warped
    orientations (NaN marks a warp's out-of-FOV voxels)."""
    acc = fixed_data
    cov = torch.ones_like(fixed_data)
    for w in warps:
        valid = torch.isfinite(w)
        acc = acc + torch.where(valid, w, 0.0)
        cov = cov + valid.to(torch.float32)
    if weight_by_coverage:
        return acc / cov
    return acc / float(1 + len(warps))
