"""BIDS derivative-tree path resolution.

Maps (prj, sub, ses, run, TE, derivative type) to file paths in the same
layout the reference produces (reference utils/qmri_utils.py:13-33 and
utils/dcm_utils.py:189-195), so outputs of either pipeline are
interchangeable. Directories are created on first use; every stage is
idempotent/resumable because the filesystem is the checkpoint.
"""

from __future__ import annotations

import os
from typing import Mapping


def mk_bids_dir(base: str, *dirs: str) -> str:
    """Create base/dirs... one level at a time; returns the final path."""
    path = base
    for d in dirs:
        path = os.path.join(path, d)
    os.makedirs(path, exist_ok=True)
    return path


def get_img_path(bids_path: str, acq: Mapping, dtype: str = "anat") -> str:
    """Resolve the path of an acquisition/derivative image.

    Args:
        bids_path: root of the projects tree (.../projects/).
        acq: metadata row with prj/sub/ses/run (+ EchoTime for recon-type
            derivatives, CoilString/T2 for simulations).
        dtype: 'anat' or a derivative dirname (resamp_1mm, recon_1mm,
            recon_1mm_t2map, recon_1mm_mask, ...).
    """
    sub, ses = acq["sub"], acq["ses"]
    if dtype == "anat":
        img_dirs = [acq["prj"], sub, ses, "anat"]
        flnm = f"{sub}_{ses}_{acq['run']}_T2w.nii.gz"
    elif "t2map" in dtype:
        img_dirs = [acq["prj"], "derivatives", dtype, sub, ses, "anat"]
        flnm = f"{sub}_{ses}_{dtype}.nii.gz"
    elif "recon" in dtype:
        img_dirs = [acq["prj"], "derivatives", dtype, sub, ses, "anat"]
        coil = acq["CoilString"] if "CoilString" in acq else None
        if coil == "Simulation":
            flnm = f"{sub}_{ses}_t2-{int(acq['T2'])}_te-{int(acq['EchoTime'])}_{dtype}.nii.gz"
        else:
            flnm = f"{sub}_{ses}_te-{int(acq['EchoTime'] * 1000)}_{dtype}.nii.gz"
    else:
        img_dirs = [acq["prj"], "derivatives", dtype, sub, ses, "anat"]
        flnm = f"{sub}_{ses}_{acq['run']}_T2w_{dtype}.nii.gz"

    dirpath = mk_bids_dir(bids_path, *img_dirs)
    return os.path.join(dirpath, flnm)
