"""Brain/phantom mask construction and brain extraction.

The counterpart of ``fetal_t2mapping_tpu.labels.masks``, replacing the
reference's SimpleITK threshold/morphology recipes:
- mask_from_labels: labels > 0 (utils/qmri_utils.py:935-951)
- extract_brain: recon * mask, i.e. sitk.Mask (:953-974)
- phantom_mask: threshold 100 + fill holes + closing(15) + dilate(10)
  (:591-623), on the device
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.volume import Volume
from ..device import resolve_device
from ..ops.morphology import binary_closing, binary_dilate, fill_holes
from ..recon.resample import to_tensor


def mask_from_labels(labels: Volume) -> Volume:
    """Binary mask = any nonzero label (host numpy, uint8)."""
    return labels.with_data((np.asarray(labels.data) > 0).astype(np.uint8))


def extract_brain(recon: Volume, mask: Volume) -> Volume:
    """Zero everything outside the mask (BET-style extraction, host numpy)."""
    if recon.shape != mask.shape:
        raise ValueError(f"shape mismatch {recon.shape} vs {mask.shape}")
    data = np.asarray(recon.data) * (np.asarray(mask.data) > 0)
    return recon.with_data(data.astype(np.asarray(recon.data).dtype))


def phantom_mask(recon: Volume, threshold: float = 100.0, closing_radius: int = 15,
                 dilate_radius: int = 10, device="cuda") -> Volume:
    """Foreground mask for NIST phantom volumes, computed on ``device``;
    returns host uint8 data."""
    m = to_tensor(recon.data, resolve_device(device)) > threshold
    m = fill_holes(m)
    m = binary_closing(m, closing_radius, box=True)
    m = binary_dilate(m, dilate_radius)
    return recon.with_data(m.to(torch.uint8).cpu().numpy())
