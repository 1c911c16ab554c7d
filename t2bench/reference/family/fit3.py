"""The plain fit of ``csrc/fit3.cu``: the rician model's 3-start multistart
for the configuration's ``prefix3`` iterations (``fits._fit3_plain``), then
the continuation of each voxel's winner for the rest of the budget
(``fits._fit3_cont_plain``).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import fit_args
from ..fits import _fit3_cont_plain, _fit3_plain


def fit_block(config: dict, s: torch.Tensor) -> Dict[str, torch.Tensor]:
    model = config["model"]
    if model != "rician":
        raise ValueError(f"the fit3 family's reference fits the rician model, not {model!r}")
    te, lo, hi, guess = fit_args(config)
    ftol, gtol, budget = float(config["ftol"]), float(config["gtol"]), int(config["max_iters"])
    kw = dict(ftol=ftol, gtol=gtol, stall_tol=max(ftol, 1e-6))
    prefix = int(config["prefix3"])
    if not 0 < prefix < budget:
        raise ValueError(f"the rician reference runs the pruned multistart; prefix3 {prefix}")
    x1, st1 = _fit3_plain(s, model, te, lo, hi, guess, max_iters=prefix, **kw)
    x, st = _fit3_cont_plain(s, model, te, lo, hi, guess, x1, st1,
                             max_iters=budget - prefix, **kw)
    return {"k": x[0], "t2": x[1], "sigma": x[2], "fun": st[0], "converged": st[1] > 0.5,
            "n_iter": st[2].to(torch.int32), "steps.fit3_multistart": st1[2].double().sum(),
            "steps.fit3_cont": (st[2] - st1[2]).double().sum()}
