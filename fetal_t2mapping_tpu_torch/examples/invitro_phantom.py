"""In-vitro phantom analysis, end to end (the reference's in-vitro notebook).

Makes a NIST-layout phantom session (9 MnCl2 spheres with the 0.55 T
ground-truth T2s, Rician noise) from a seed, runs stage 3 on it (sphere
labels -> masked fit -> maps -> phantom ROI CSV) and, with ``figures``,
draws the notebook's two artifacts (reference
notebooks/20240924_ada_qmri_jmri_invitro.ipynb): per-sphere decay curves
with the fitted model and R^2, and a rendered T2 map. The figures need
matplotlib, which is imported only to draw them.

Run:  python -m fetal_t2mapping_tpu_torch.examples.invitro_phantom [out_dir]
          [--device cpu] [--no-figures]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import pandas as pd

from .. import config as C
from ..core import Volume, nifti
from ..labels.phantom import phantom_labels_from_seeds
from ..pipeline.t2map_pipeline import process_t2maps
from ..utils.bids import get_img_path
from ..utils.metadata import set_metadata
from ..utils.profiling import profiler

TES = [114, 202, 299]
SEEDS = [[8, 8, 10], [24, 8, 10], [40, 8, 10],
         [8, 24, 10], [24, 24, 10], [40, 24, 10],
         [8, 40, 10], [24, 40, 10], [40, 40, 10]]
GT_LF = list(C.PHANTOM_GT_LF.values())
K_TRUE = 650.0
NOISE_SIGMA = 4.0


def make_phantom_tree(root: str, rng, device="cuda"):
    """The phantom session as a BIDS tree of recons, masks and sphere
    labels under ``root``, with its metadata CSV; returns (bids path, logs
    path, labels)."""
    bids = os.path.join(root, "projects/")
    logs = os.path.join(root, "dicom/logs/")
    os.makedirs(logs, exist_ok=True)
    shape = (20, 48, 48)
    geom = Volume(np.zeros(shape, np.float32), spacing=(1, 1, 1), origin=(0, 0, 0))
    labels = np.asarray(phantom_labels_from_seeds(geom, SEEDS, radius=3, device=device).data)
    t2_map = np.zeros(shape, np.float32)
    for i, gt in enumerate(GT_LF, start=1):
        t2_map[labels == i] = gt
    mask = (labels > 0).astype(np.uint8)

    rows = []
    for te in TES:
        acq = {"prj": "prj-003", "sub": "sub-001", "ses": "ses-01",
               "run": f"run-{te}", "EchoTime": te / 1000.0,
               "ImageOrientationPatientSTR": "ax", "CoilString": "Body"}
        clean = np.where(mask > 0, K_TRUE * np.exp(-te / np.maximum(t2_map, 1e-3)), 0.0)
        n1 = rng.normal(0, NOISE_SIGMA, shape)
        n2 = rng.normal(0, NOISE_SIGMA, shape)
        sig = np.sqrt((clean + n1) ** 2 + n2 ** 2).astype(np.float32)
        nifti.write(get_img_path(bids, acq, C.RECON_DIRNAME), geom.with_data(sig))
        nifti.write(get_img_path(bids, acq, C.MASK_DIRNAME), geom.with_data(mask))
        nifti.write(get_img_path(bids, acq, C.PHANTOM_LABELS_DIRNAME),
                    geom.with_data(labels.astype(np.uint8)))
        rows.append(acq)
    pd.DataFrame(rows).to_csv(os.path.join(logs, "synthetic.csv"), index=False)
    return bids, logs, labels


def draw_figures(out_dir: str, summary: dict, metadata, bids: str, labels) -> list:
    """Per-sphere decay curves with the fitted model, and the T2 map."""
    from ..analysis.figures import map_montage, relaxation_curves

    t2map = np.asarray(nifti.read(summary["maps"]["t2"]).data)
    kmap = np.asarray(nifti.read(summary["maps"]["k"]).data)
    acq0 = metadata[0]
    echoes = {te: np.asarray(nifti.read(get_img_path(
        bids, {**acq0, "EchoTime": te / 1000.0, "run": f"run-{te}"},
        C.RECON_DIRNAME)).data) for te in TES}
    roi_means, fits, gt = {}, {}, {}
    for i in range(1, 10):
        m = labels == i
        name = f"T2-{i + 2}"
        roi_means[name] = np.array([echoes[te][m].mean() for te in TES])
        fits[name] = (float(kmap[m].mean()), float(t2map[m].mean()))
        gt[name] = float(GT_LF[i - 1])
    decay_path = relaxation_curves(
        TES, roi_means, os.path.join(out_dir, "phantom_decay_fits.png"),
        fits=fits, gt=gt, title="phantom sphere decay fits")
    map_path = map_montage(t2map, os.path.join(out_dir, "phantom_t2map.png"),
                           n_slices=3, vmax=650.0, mask=labels > 0,
                           title="fitted T2 map")
    return [decay_path, map_path]


def main(out_dir=None, device="cuda", figures: bool = True) -> pd.DataFrame:
    """Run the phantom session on ``device``; returns the per-sphere ROI
    table (meanT2, stdT2, trueT2, ...). ``figures`` draws the two PNGs into
    ``out_dir`` (and the pipeline's convergence plots)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "ft2_invitro_demo")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    work = tempfile.mkdtemp(prefix="ft2_phantom_")
    try:
        bids, logs, labels = make_phantom_tree(work, rng, device=device)
        metadata = set_metadata(logs, ["synthetic.csv"], low_field=True)
        cfg = C.fit_config("gaussian", low_field=True)
        summaries = process_t2maps(metadata, bids, TES, cfg, phantom=True, low_field=True,
                                   make_plots=figures, device=device)
        s = summaries[0]
        roi = pd.read_csv(s["roi_csv"])
        print("\nPhantom ROI stats vs NMR ground truth:")
        print(roi.to_string(index=False))
        if figures:
            paths = draw_figures(out_dir, s, metadata, bids, labels)
            print("\nfigures: " + "\n         ".join(paths))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("\nstage timing:\n" + profiler.report(), flush=True)
    return roi


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-figures", dest="figures", action="store_false")
    args = ap.parse_args()
    main(args.out_dir, device=args.device, figures=args.figures)
