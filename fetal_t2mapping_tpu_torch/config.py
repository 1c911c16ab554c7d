"""Declarative configuration for the whole pipeline.

Consolidates every hardcoded table scattered through the reference:
- derivative directory names        (reference utils/metadata_utils.py:4-17)
- default echo times per field      (reference run_t2mapping.py:540-545)
- fit-parameter table               (reference run_t2mapping.py:29-111)
- NIST phantom ground-truth T2s     (reference run_t2mapping.py:14-27)
- phantom seed coordinates          (reference run_qmri_reconstruction.py:53-91)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# --------------------------------------------------------------------------
# Derivative directory names (the BIDS derivative tree layout)
IN_DIRNAME = "anat"
RESAMP_DIRNAME = "resamp_1mm"
RECON_DIRNAME = "recon_1mm"
MASK_DIRNAME = "recon_1mm_mask"
SYNTHSEG_DIRNAME = "recon_1mm_synthseg"
BET_DIRNAME = "recon_1mm_bet"
FETA_DIRNAME = "recon_1mm_feta"
JHU_DIRNAME = "recon_1mm_jhu"
HO_DIRNAME = "recon_1mm_ho"
MNI_DIRNAME = "recon_1mm_mni152"
PHANTOM_LABELS_DIRNAME = "recon_1mm_label"
N4_DIRNAME = RESAMP_DIRNAME + "_n4"
T2MAP_DIRNAME = RECON_DIRNAME + "_t2map"

# --------------------------------------------------------------------------
# Default echo times (ms)
DEFAULT_TES_LF: List[int] = [114, 202, 299]  # 0.55 T Siemens Freemax
DEFAULT_TES_HF: List[int] = [115, 202, 299]  # 1.5 T Siemens Sola


def default_tes(low_field: bool) -> List[int]:
    return list(DEFAULT_TES_LF if low_field else DEFAULT_TES_HF)


# --------------------------------------------------------------------------
# NIST system-phantom ground truth (MnCl2 array, NMR-spectrometer T2 in ms)
PHANTOM_GT_LF: Dict[str, float] = {
    "T2-3": 594, "T2-4": 416, "T2-5": 284, "T2-6": 221, "T2-7": 167,
    "T2-8": 122, "T2-9": 80, "T2-10": 53, "T2-11": 41,
}
PHANTOM_GT_HF: Dict[str, float] = {
    "T2-1": 1044, "T2-2": 624, "T2-3": 428, "T2-4": 258, "T2-5": 186,
    "T2-6": 137, "T2-7": 90, "T2-8": 63, "T2-9": 44, "T2-10": 27,
    "T2-11": 19, "T2-12": 15, "T2-13": 10, "T2-14": 8,
}


def phantom_gt(low_field: bool) -> Tuple[List[float], List[str]]:
    """(gt values, sphere ids) for the phantom accuracy oracle."""
    table = PHANTOM_GT_LF if low_field else PHANTOM_GT_HF
    ids = list(table.keys())
    return [table[i] for i in ids], ids


# --------------------------------------------------------------------------
# Phantom seed voxels (x, y, z), keyed by acquisition setup.
PHANTOM_SEEDS: Dict[str, List[List[int]]] = {
    # prj-003 ses-01/02, MnCl2 plate 4, 0.55 T body coil (the active set)
    "prj-003_mncl2_plate4_lf_body": [
        [139, 149, 105], [163, 130, 105], [194, 129, 105], [220, 147, 105],
        [229, 176, 105], [221, 206, 105], [195, 225, 105], [165, 226, 105],
        [176, 206, 105],
    ],
    "prj-003_nicl2_plate4_lf_body": [
        [139, 149, 145], [163, 130, 145], [194, 129, 145], [220, 147, 145],
        [229, 176, 145], [221, 206, 145], [195, 225, 145], [165, 226, 145],
        [176, 206, 145],
    ],
    "prj-002_mncl2_plate4_lf_head": [
        [168, 199, 43], [168, 168, 38], [168, 141, 53], [168, 128, 80],
        [168, 133, 111], [169, 155, 133], [169, 187, 136], [169, 213, 123],
        [169, 194, 111],
    ],
    "prj-002_mncl2_plate4_hf_head": [
        [155, 221, 102], [135, 198, 102], [134, 167, 102], [150, 141, 102],
        [178, 129, 102], [208, 137, 102], [227, 160, 102], [229, 192, 102],
        [212, 218, 102], [185, 230, 102], [188, 207, 102], [154, 187, 102],
        [175, 152, 102], [209, 173, 102],
    ],
}
DEFAULT_PHANTOM_SEEDS_KEY = "prj-003_mncl2_plate4_lf_body"

# --------------------------------------------------------------------------
# Fit configuration


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Everything the voxel-fit solver needs.

    ``model`` is one of 'gaussian' (params k, t2), 'gaussian_rician' or
    'rician' (params k, t2, sigma). Bounds replicate the reference's
    L-BFGS-B box constraints; the solver enforces them by projection.
    """

    model: str
    initial_guess: Tuple[float, ...]
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    # scipy-compatible stopping knobs (the solver runs tighter by default)
    ftol: float = 1e-9
    gtol: float = 0.0
    max_iters: int = 60
    # prior=False: per-voxel k lower bound = signal at min TE, t2 in (10,2000)
    prior: bool = True
    # normalize each voxel's signal by its max before fitting
    norm: bool = False
    # use the closed-form log-linear initializer instead of initial_guess
    loglinear_init: bool = True

    @property
    def n_params(self) -> int:
        return 2 if self.model == "gaussian" else 3

    def __post_init__(self):
        if self.model not in ("gaussian", "gaussian_rician", "rician"):
            raise ValueError(f"unknown model {self.model!r}")
        if not (len(self.initial_guess) == len(self.lower) == len(self.upper) == self.n_params):
            raise ValueError("initial_guess/lower/upper length must match n_params")


# (model, low_field) -> reference fit-parameter row. The 'norm' variants are
# unsupported in the reference (it exits) and here raise.
_FIT_TABLE = {
    ("gaussian", True): dict(
        initial_guess=(650.0, 165.0), lower=(600.0, 10.0), upper=(10000.0, 600.0)),
    ("gaussian_rician", True): dict(
        initial_guess=(650.0, 110.0, 40.0), lower=(550.0, 10.0, 2.0), upper=(10000.0, 600.0, 1000.0)),
    ("rician", True): dict(
        initial_guess=(650.0, 110.0, 40.0), lower=(550.0, 10.0, 2.0), upper=(900.0, 600.0, 1000.0)),
    ("gaussian", False): dict(
        initial_guess=(890.0, 165.0), lower=(850.0, 10.0), upper=(30000.0, 600.0)),
    ("gaussian_rician", False): dict(
        initial_guess=(890.0, 110.0, 40.0), lower=(850.0, 30.0, 2.0), upper=(30000.0, 600.0, 1000.0)),
    ("rician", False): dict(
        initial_guess=(17.0, 40.0, 0.15), lower=(850.0, 30.0, 7.0), upper=(30000.0, 600.0, 200.0)),
}


def fit_config(model: str, low_field: bool, *, prior: bool = True,
               norm: bool = False, **overrides) -> FitConfig:
    """Build the fit configuration for a (noise model, field, norm) combo.

    Mirrors the reference's set_fit_params dispatch (run_t2mapping.py:29-111)
    including its refusal of normalized fits.
    """
    if norm:
        raise ValueError(
            "normalized fits have no parameter table (the reference exits here too); "
            "define bounds explicitly via overrides")
    key = (model, low_field)
    if key not in _FIT_TABLE:
        raise ValueError(f"no fit parameters for model={model!r} low_field={low_field}")
    row = dict(_FIT_TABLE[key])
    row.update(overrides)
    return FitConfig(model=model, prior=prior, norm=norm, **row)


# no-prior per-voxel bound constants (reference run_t2mapping.py:243-245)
NO_PRIOR_K_UPPER = 10000.0
NO_PRIOR_T2_BOUNDS = (10.0, 2000.0)
