"""The plain reference that decides ``correct``, and the comparison.

``fit`` runs the plain fit of the configuration's kernel family over masked
voxels the benchmark made, as the configuration states them (bounds,
start, budget, tolerances, the multistart prefix), in blocks of rows. The
family is the configuration's ``counts`` key, the one whose work
``counts/<counts>.py`` counts; its fit is ``family/<counts>.py``, found by
that name, over the frozen plain fits of ``fits.py``, so a new family is a
new file and chooses nothing here. ``off_voxels`` counts the grid voxels
where a program map leaves the reference's by more than the band. With
``dtype=torch.bfloat16`` the same code is the control: the reference one
precision below the configuration's float32. Imports nothing of the
program.
"""

from __future__ import annotations

import importlib
import os
from typing import Dict

import torch

#: rows of one block of the reference fit: a 240^3 request's masked voxels
#: at once (the plain loops cost a launch per operation, whatever the rows)
BLOCK = 1 << 22
#: a voxel is off where |program - reference| > BAND * max(|reference|, 1)
#: in a float map, or where a count or flag differs at all
BAND = 1e-3


def fit_args(config: dict):
    """(te, lo, hi, guess) as the fit runs them: the rician sigma bound kept
    off zero and the default start at the box's middle, as the program's
    argument check does."""
    te = tuple(float(t) for t in config["te"])
    lo = tuple(float(v) for v in config["lower"])
    hi = tuple(float(v) for v in config["upper"])
    if config["model"] == "rician":
        lo = lo[:2] + (max(lo[2], 1e-2),)
    guess = config.get("initial_guess")
    guess = tuple((a + b) / 2.0 for a, b in zip(lo, hi)) if guess is None \
        else tuple(float(v) for v in guess)
    return te, lo, hi, guess


def family_fit(name: str):
    """``fit_block`` of ``family/<name>.py``: the plain fit of the kernel
    family ``name``. Raises KeyError, naming the path it looked for, where
    there is no such file."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "family", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no reference fit for the kernel family {name!r}: {path} is missing")
    return importlib.import_module(f"{__name__}.family.{name}").fit_block


def fit(config: dict, signal: torch.Tensor, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference fit of (N, T) float32 voxels, in ``dtype``: per-voxel
    k, t2, sigma, fun (float32), converged (bool), n_iter (int32), and
    ``steps.<kernel>``, the accepted steps summed over the voxels for each
    kernel the configuration's fit launches (what the roofline counts)."""
    fit_block = family_fit(config["counts"])
    parts = []
    for start in range(0, signal.shape[0], BLOCK):
        block = signal[start:start + BLOCK].to(dtype)
        parts.append(fit_block(config, block))
    out = {}
    for key in parts[0]:
        vals = [p[key] for p in parts]
        out[key] = sum(float(v) for v in vals) if key.startswith("steps.") else torch.cat(vals)
    for key in ("k", "t2", "sigma", "fun"):
        out[key] = out[key].to(torch.float32)
    return out


def to_grid(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked-voxel values scattered into the mask's grid, 0 elsewhere."""
    out = torch.zeros(mask.shape, dtype=values.dtype, device=values.device)
    out[mask] = values
    return out


def off_voxels(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> int:
    """Grid voxels where any map of ``program`` is off ``reference``'s (same
    keys, same grid): float maps beyond ``BAND``, other maps unequal; two
    NaNs agree."""
    off = None
    for key, ref in reference.items():
        got = program[key].to(ref.device)
        if ref.dtype.is_floating_point:
            got = got.to(ref.dtype)
            bad = (got - ref).abs() > BAND * ref.abs().clamp(min=1.0)
            bad = (bad | (got.isnan() != ref.isnan())) & ~(got.isnan() & ref.isnan())
        else:
            bad = got.to(ref.dtype) != ref
        off = bad if off is None else off | bad
    return int(off.sum())
