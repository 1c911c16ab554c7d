"""Writers for fit outputs: NIfTI maps + phantom ROI statistics CSV.

The output contract of ``fetal_t2mapping_tpu.utils.maps_io`` (reference
utils/t2map_utils.py:18-59):
- four maps (t2/k/sigma/res) copying the recon geometry, named
  ``sim-{sim}_{param}map_ada-{fit}.nii.gz``
- per-ROI nanmean/nanstd of T2/k/sigma against spectrometer ground truth,
  written with the stdlib ``csv`` module in the same columns and order
  (NaN as an empty cell, as pandas writes it).
"""

from __future__ import annotations

import csv
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Sequence

import numpy as np

from ..core import nifti
from ..core.volume import Volume
from .bids import get_img_path

ROI_COLUMNS = ("id", "trueT2", "meanT2", "stdT2", "meanK", "stdK", "meanC", "stdC")


def save_nifti_maps(out, bids_path: str, acq: Mapping, t2map_dirname: str,
                    sim: str, fit: str) -> dict:
    """Write t2/k/sigma/res maps; returns {param: path}.

    The four writes run on a small thread pool (gzip compression releases
    the GIL) and have all landed when this returns."""
    base = get_img_path(bids_path, acq, t2map_dirname)
    if "t2map.nii.gz" not in base:
        # the substring replace below would silently no-op and write all
        # four maps to ONE path — fail loudly instead
        raise ValueError(
            f"t2map_dirname {t2map_dirname!r} resolves to {base!r}, which "
            "does not end in 't2map.nii.gz'; cannot derive map filenames")
    jobs = []
    for vol, param in zip((out.t2, out.k, out.sigma, out.res), ("t2", "k", "sigma", "res")):
        path = base.replace("t2map.nii.gz", f"sim-{sim}_{param}map_ada-{fit}.nii.gz")
        jobs.append((param, path, vol))
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futures = [ex.submit(nifti.write, path, vol, np.float32)
                   for _, path, vol in jobs]
        for fut in futures:
            fut.result()
    return {param: path for param, path, _ in jobs}


def phantom_roi_stats(t2_map: np.ndarray, k_map: np.ndarray, sigma_map: np.ndarray,
                      label: np.ndarray, ids: Sequence[str],
                      gt: Sequence[float]) -> List[Dict]:
    """Per-sphere nanmean/nanstd of the fitted maps vs ground-truth T2, one
    dict per sphere keyed by ``ROI_COLUMNS``.

    Labeled voxels the fit mask excluded hold 0.0 in the maps and ARE
    averaged in — reference parity (its maps are zero-filled and its
    nanmean runs over ``label==i`` unmasked)."""
    rows = []
    for i, (sphere, true_t2) in enumerate(zip(ids, gt), start=1):
        sel = label == i
        with np.errstate(invalid="ignore"):
            rows.append({
                "id": sphere,
                "trueT2": true_t2,
                "meanT2": np.nanmean(t2_map[sel]) if sel.any() else np.nan,
                "stdT2": np.nanstd(t2_map[sel]) if sel.any() else np.nan,
                "meanK": np.nanmean(k_map[sel]) if sel.any() else np.nan,
                "stdK": np.nanstd(k_map[sel]) if sel.any() else np.nan,
                "meanC": np.nanmean(sigma_map[sel]) if sel.any() else np.nan,
                "stdC": np.nanstd(sigma_map[sel]) if sel.any() else np.nan,
            })
    return rows


def _cell(v):
    if isinstance(v, (float, np.floating)) and math.isnan(v):
        return ""
    return v


def save_phantom_csv(out, label_vol: Volume, ids: Sequence[str], gt: Sequence[float],
                     bids_path: str, acq: Mapping, t2map_dirname: str,
                     sim: str, fit: str) -> str:
    rows = phantom_roi_stats(
        np.asarray(out.t2.data), np.asarray(out.k.data), np.asarray(out.sigma.data),
        np.asarray(label_vol.data), ids, gt,
    )
    path = get_img_path(bids_path, acq, t2map_dirname).replace(
        "t2map.nii.gz", f"sim-{sim}_ROI_data_ada-{fit}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(ROI_COLUMNS)
        for row in rows:
            writer.writerow([_cell(row[c]) for c in ROI_COLUMNS])
    return path
