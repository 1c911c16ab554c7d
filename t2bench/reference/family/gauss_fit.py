"""The plain fit of ``csrc/gauss_fit.cu``: the gaussian model's mean-SSE
fit of (k, T2) in the configuration's prior box (``fits._gauss_fit_plain``).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import fit_args
from ..fits import _gauss_fit_plain


def fit_block(config: dict, s: torch.Tensor) -> Dict[str, torch.Tensor]:
    if config["model"] != "gaussian":
        raise ValueError(f"the gauss_fit family fits the gaussian model, not {config['model']!r}")
    te, lo, hi, _ = fit_args(config)
    ftol, gtol, budget = float(config["ftol"]), float(config["gtol"]), int(config["max_iters"])
    k, t2, f, conv, nit = _gauss_fit_plain(
        s, te, lo, hi, max_iters=budget, ftol=ftol, gtol=gtol, no_prior=False,
        full_budget=False, stall_iters=3, stall_tol=max(ftol, 1e-3))
    return {"k": k, "t2": t2, "sigma": torch.zeros_like(k), "fun": f, "converged": conv,
            "n_iter": nit, "steps.gauss_fit": nit.double().sum()}
