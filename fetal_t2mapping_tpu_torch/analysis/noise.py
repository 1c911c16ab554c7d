"""Background-noise estimation from outside-mask voxels (host numpy, a
copy of ``fetal_t2mapping_tpu.analysis.noise`` over the port's
``EchoStack``).

Functional version of the reference's (disabled) in-vitro noise probe
(utils/t2map_utils.py:92-112): statistics of the signal outside the fit
mask, per echo time — used to sanity-check sigma bounds for the Rician
fits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.stack import EchoStack


def estimate_background_noise(stack: EchoStack) -> Dict[str, np.ndarray]:
    """Mean/std of outside-mask signal per TE + Rayleigh-corrected sigma.

    For magnitude MR background (pure noise), the Rayleigh relationships
    sigma = mean / sqrt(pi/2) = std / sqrt(2 - pi/2) recover the underlying
    Gaussian noise level from background statistics.
    """
    outside = stack.signal[~stack.mask]  # (N_out, nTE)
    if outside.size == 0:
        raise ValueError("mask covers the whole volume; no background voxels")
    mean = outside.mean(axis=0)
    std = outside.std(axis=0)
    return {
        "tes": np.asarray(stack.tes),
        "mean": mean,
        "std": std,
        "sigma_from_mean": mean / np.sqrt(np.pi / 2.0),
        "sigma_from_std": std / np.sqrt(2.0 - np.pi / 2.0),
        "n_background": np.asarray(outside.shape[0]),
    }
