"""scipy ``curve_fit`` accuracy oracle for the gaussian fit (CPU, per voxel).

The yardstick of the JAX package's bench ('<1e-3 max relative T2 error vs
scipy curve_fit', ``fetal_t2mapping_tpu.models.oracle.curve_fit_t2``).
Intentionally a slow per-voxel Python loop: use it on a sample.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import curve_fit


def curve_fit_t2(signal: np.ndarray, te: np.ndarray,
                 lo=(0.0, 1.0), hi=(np.inf, 5000.0)) -> np.ndarray:
    """(N, T) -> (N, 2) [k, T2] via scipy curve_fit on the gaussian model."""
    def model(t, k, t2):
        return k * np.exp(-t / t2)

    out = np.zeros((signal.shape[0], 2))
    for i, s in enumerate(signal):
        # weighted log-linear start, as the fit's own initializer
        w = np.maximum(s, 1e-6) ** 2
        A = np.stack([np.ones_like(te), -te], axis=1)
        th = np.linalg.lstsq(A * w[:, None] ** 0.5, np.log(np.maximum(s, 1e-6)) * w ** 0.5, rcond=None)[0]
        p0 = [float(np.exp(th[0])), float(np.clip(1.0 / max(th[1], 1e-6), lo[1], hi[1]))]
        p0 = np.clip(p0, lo, np.minimum(hi, 1e12))
        try:
            popt, _ = curve_fit(model, te, s, p0=p0, bounds=(lo, hi), maxfev=10000)
        except RuntimeError:
            popt = p0
        out[i] = popt
    return out
