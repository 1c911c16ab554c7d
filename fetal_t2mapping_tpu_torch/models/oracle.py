"""scipy accuracy oracles (CPU, per voxel): ``curve_fit`` for the gaussian
fit and the same-model L-BFGS-B fit for every model.

The yardsticks of the JAX package's bench (``fetal_t2mapping_tpu.models
.oracle``): '<1e-3 max relative T2 error vs scipy curve_fit' for gaussian,
and the objective gap against an L-BFGS-B fit of the same objective
(reference run_t2mapping.py:120-312: L-BFGS-B, jac=False, box bounds) for
the 3-parameter models. Intentionally slow per-voxel Python loops: use
them on a sample.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import curve_fit, minimize
from scipy.special import i0e

from ..config import FitConfig, NO_PRIOR_K_UPPER, NO_PRIOR_T2_BOUNDS


def _objective(model: str):
    """The reference's per-voxel objective f(p, te, s) in float64 numpy."""
    if model == "gaussian":
        def f(p, te, s):
            r = s - p[0] * np.exp(-te / p[1])
            return np.mean(r * r)
        return f
    if model == "gaussian_rician":
        def f(p, te, s):
            m = np.sqrt(p[0] ** 2 * np.exp(-2 * te / p[1]) + p[2] ** 2)
            r = s - m
            return np.mean(r * r)
        return f
    if model == "rician":
        def f(p, te, s):
            k, t2, sigma = p
            m = k * np.exp(-te / t2)
            s2 = sigma ** 2
            x = m * s / s2
            ll = np.sum(
                np.log(np.maximum(s, 1e-20)) - np.log(s2)
                - (s ** 2 + m ** 2) / (2 * s2)
                + (np.abs(x) + np.log(i0e(x)))
            )
            return -ll
        return f
    raise ValueError(model)


def _voxel_bounds(cfg: FitConfig, signal: np.ndarray):
    lo = list(cfg.lower)
    hi = list(cfg.upper)
    if not cfg.prior:
        lo[0], hi[0] = float(signal[0]), NO_PRIOR_K_UPPER
        lo[1], hi[1] = NO_PRIOR_T2_BOUNDS
    return lo, hi


def fit_voxel_scipy(signal: np.ndarray, te: np.ndarray, cfg: FitConfig,
                    *, tight: bool = True) -> Tuple[np.ndarray, bool, int, float]:
    """L-BFGS-B fit of one voxel from ``cfg.initial_guess``. tight=True uses
    oracle-grade tolerances; tight=False the reference's per-model options
    (gaussian: ftol 1e-6; others: ftol/gtol 1e-2, run_t2mapping.py:38-106).
    Returns (x, success, n_iter, objective)."""
    obj = _objective(cfg.model)
    lo, hi = _voxel_bounds(cfg, signal)
    if cfg.norm:
        signal = signal / max(signal.max(), 1e-12)
    if tight:
        options = {"ftol": 1e-12, "gtol": 1e-10, "maxls": 100, "maxiter": 500}
    elif cfg.model == "gaussian":
        options = {"ftol": 1e-6, "maxls": 50}
    else:
        options = {"ftol": 1e-2, "gtol": 1e-2, "maxls": 50}
    result = minimize(
        obj, np.asarray(cfg.initial_guess, float), args=(te, signal),
        method="L-BFGS-B", bounds=list(zip(lo, hi)), options=options, jac=False,
    )
    return result.x, bool(result.success), int(result.nit), float(result.fun)


def fit_batch_scipy(signal: np.ndarray, te: np.ndarray, cfg: FitConfig,
                    *, tight: bool = True) -> np.ndarray:
    """(N, T) -> (N, P) L-BFGS-B parameters (loop; oracle only)."""
    return np.stack([fit_voxel_scipy(s, te, cfg, tight=tight)[0] for s in signal])


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
