"""SynthSeg (FreeSurfer aseg ids) -> FeTA 7-class remap.

The counterpart of ``fetal_t2mapping_tpu.labels.feta``: one table lookup on
the device in place of the reference's chain of boolean masks
(utils/qmri_utils.py:976-1009). The table is the fixed anatomical
correspondence used there: 1 CSF, 2 cortical GM, 3 WM, 4 ventricles,
5 cerebellum, 6 deep GM, 7 brainstem.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.volume import Volume
from ..device import resolve_device
from ..recon.resample import to_tensor

FETA_CLASS_NAMES = {
    0: "background", 1: "csf", 2: "gm", 3: "wm", 4: "ventricles",
    5: "cerebellum", 6: "deep_gm", 7: "brainstem",
}

_SYNTHSEG_TO_FETA = {
    24: 1,
    3: 2, 42: 2,
    2: 3, 41: 3,
    4: 4, 5: 4, 14: 4, 15: 4, 43: 4, 44: 4,
    7: 5, 8: 5, 46: 5, 47: 5,
    10: 6, 11: 6, 12: 6, 13: 6, 17: 6, 18: 6, 26: 6, 28: 6,
    49: 6, 50: 6, 51: 6, 52: 6, 53: 6, 54: 6, 58: 6, 60: 6,
    16: 7,
}

_LUT = np.zeros(256, np.uint8)
for _k, _v in _SYNTHSEG_TO_FETA.items():
    _LUT[_k] = _v


def synthseg_to_feta(labels: Volume, device="cuda") -> Volume:
    """Remap a SynthSeg label volume to FeTA classes on ``device``
    (geometry preserved). Returns a Volume whose data is a uint8 tensor on
    ``device``; ``.cpu().numpy()`` downloads it."""
    dev = resolve_device(device)
    lut = torch.from_numpy(_LUT).to(dev)
    idx = to_tensor(labels.data, dev).to(torch.int64).clamp(0, 255)
    return labels.with_data(lut[idx])
