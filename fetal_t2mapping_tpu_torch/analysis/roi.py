"""ROI statistics: per-label T2 aggregation on the device.

The counterpart of ``fetal_t2mapping_tpu.analysis.roi``, which replaces the
reference's per-label Python loops over boolean intersections
(utils/ada_utils.py:130-216, 885-968). Per-label moments are one device
reduction over all labels; the atlas and tissue tables combine and erode
the label masks on the device and compute mean, median and std with numpy
on the gathered voxels, as the JAX package does, so those are exact.

The moments are sums of one-hot label weights against (1, v, v^2) in
float64, chunk by chunk in a fixed order (a matrix product per chunk):
no atomics, so two runs on the card give the same bits, and the counts are
exact.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from ..device import resolve_device
from ..ops.morphology import binary_erode
from ..recon.resample import to_tensor

FETA_LABELS = [
    {"index": 0, "name": "background"},
    {"index": 1, "name": "csf"},
    {"index": 2, "name": "gm"},
    {"index": 3, "name": "wm"},
    {"index": 4, "name": "ventr"},
    {"index": 5, "name": "cerebellum"},
    {"index": 6, "name": "deep_gm"},
    {"index": 7, "name": "bs"},
]

# voxels per one-hot chunk of _label_moments: (chunk x labels) float64
# weights stay ~100 MB at ~50 labels
_MOMENT_CHUNK = 1 << 18


def parse_xml_labels(xml_file: str) -> List[dict]:
    """Parse an FSL atlas XML (JHU / HarvardOxford) into label dicts.

    Indices are shifted +1 like the reference (utils/ada_utils.py:27-39)
    because label 0 in the warped atlas volume is background.
    """
    root = ET.parse(xml_file).getroot()
    labels = []
    for label in root.findall(".//label"):
        labels.append({
            "index": int(label.get("index")) + 1,
            "name": (label.text or "").strip(),
        })
    return labels


def _values(x, dev: torch.device) -> torch.Tensor:
    """A value map on ``dev`` in its own dtype (the statistics are taken in
    it, as numpy takes them in the JAX package)."""
    if torch.is_tensor(x):
        return x.to(dev)
    return torch.from_numpy(np.array(x)).to(dev)


def _label_moments(values: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                   n_labels: int) -> torch.Tensor:
    """(n_labels, 3) float64 per-label (count, sum, sum of squares) over the
    valid voxels; label ids outside [0, n_labels) are dropped."""
    valid = valid & (labels >= 0) & (labels < n_labels)
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    v = torch.where(valid, values, torch.zeros_like(values)).double()
    w = torch.stack([valid.double(), v, v * v], dim=1)
    ids = torch.arange(n_labels, device=values.device)
    out = torch.zeros((n_labels, 3), dtype=torch.float64, device=values.device)
    for start in range(0, lab.shape[0], _MOMENT_CHUNK):
        onehot = (lab[start:start + _MOMENT_CHUNK, None] == ids).double()
        out += onehot.T @ w[start:start + _MOMENT_CHUNK]
    return out


def roi_stats_per_label(values, labels, mask=None, n_labels: Optional[int] = None,
                        device="cuda") -> pd.DataFrame:
    """mean / std / n of ``values`` per label id in one device pass (labels
    > 0 and, if given, inside ``mask``)."""
    dev = resolve_device(device)
    values = to_tensor(values, dev, torch.float32).reshape(-1)
    labels = to_tensor(labels, dev).reshape(-1).long()
    if n_labels is None:
        n_labels = int(labels.max()) + 1
    valid = labels > 0
    if mask is not None:
        valid &= to_tensor(mask, dev).reshape(-1) > 0
    cnt, s1, s2 = _label_moments(values, labels, valid, int(n_labels)).cpu().numpy().T
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s1 / cnt
        var = np.maximum(s2 / cnt - mean * mean, 0.0)
    return pd.DataFrame({
        "label": np.arange(n_labels),
        "n": cnt.astype(int),
        "mean": mean,
        "std": np.sqrt(var),
    })


def _erode_bool(mask3d: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3-D binary erosion with a full 3x3x3 (26-connected) structure,
    scipy.ndimage.binary_erosion(structure=generate_binary_structure(3, 3))
    as the reference uses it (utils/ada_utils.py:140, 168)."""
    return binary_erode(mask3d, radius=1, box=True, iterations=iterations)


def _stats(data: np.ndarray) -> dict:
    return {
        "mean": float(np.mean(data)) if data.size else np.nan,
        "median": float(np.median(data)) if data.size else np.nan,
        "std": float(np.std(data)) if data.size else np.nan,
        "nvoxel": int(data.size),
    }


def t2_per_atlas_roi(t2map, feta, atlas, atlas_labels: Sequence[dict],
                     tissue_class: int, erode: bool = True, device="cuda") -> pd.DataFrame:
    """Per-atlas-label T2 stats inside one FeTA tissue class.

    Reference semantics (utils/ada_utils.py:162-214): intersect
    (feta == tissue_class) with (atlas == label), erode the intersection with
    a 26-connected element, then mean/median/std/n of the T2 map.
    """
    dev = resolve_device(device)
    t2map = _values(t2map, dev)
    feta_sel = to_tensor(feta, dev) == tissue_class
    atlas = to_tensor(atlas, dev)
    rows = []
    for label in atlas_labels:
        inter = feta_sel & (atlas == label["index"])
        if erode:
            inter = _erode_bool(inter)
        rows.append({"roi": label["name"], "index": label["index"],
                     **_stats(t2map[inter].cpu().numpy())})
    return pd.DataFrame(rows)


def t2_per_tissue_feta(t2map, feta, *, erode: bool = True,
                       gt: Optional[Dict[str, float]] = None, device="cuda") -> pd.DataFrame:
    """Per-FeTA-tissue T2 stats, optional MAPE vs literature ground truth.

    Reference semantics: utils/ada_utils.py:885-968 — each tissue class mask
    is eroded one voxel (26-connected) before aggregation; when a ground
    truth table is given, mean-absolute-percentage error is reported.
    """
    dev = resolve_device(device)
    t2map = _values(t2map, dev)
    feta = to_tensor(feta, dev)
    rows = []
    for label in FETA_LABELS:
        if label["index"] == 0:
            continue
        sel = feta == label["index"]
        if erode:
            sel = _erode_bool(sel)
        data = t2map[sel].cpu().numpy()
        row = {"tissue": label["name"], "index": label["index"], **_stats(data)}
        if gt and label["name"] in gt and data.size:
            row["gt"] = gt[label["name"]]
            row["mape"] = float(np.mean(np.abs(data - gt[label["name"]]) / gt[label["name"]]) * 100)
        rows.append(row)
    return pd.DataFrame(rows)
