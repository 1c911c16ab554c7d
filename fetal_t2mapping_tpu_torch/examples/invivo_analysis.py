"""In-vivo statistical analysis, end to end (the reference's JMRI notebook).

Makes fitted T2 maps, FeTA tissue labels and atlas labels for several
subjects x sessions from a seed (with controlled inter-session
variability), then runs the analysis layer the reference keeps in
notebooks/20240910_ada_jmri.ipynb + utils/ada_utils.py: per-ROI T2 tables
(on ``device``), the inter-session coefficient of variation, a Wilcoxon
test and a Pearson regression between sessions and, with ``figures``, the
CoV boxplots, the regression scatter, WM/GM violins, map montages and
relaxation curves. The figures need matplotlib, which is imported only to
draw them.

Run:  python -m fetal_t2mapping_tpu_torch.examples.invivo_analysis [out_dir]
          [--device cpu] [--no-figures]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import pandas as pd

from ..analysis.roi import t2_per_atlas_roi, t2_per_tissue_feta
from ..analysis.stats import cov_by_group, paired_wilcoxon, pearson_regression

SUBJECTS = ["sub-001", "sub-002", "sub-003"]
SESSIONS = ["ses-01", "ses-02"]
SHAPE = (24, 48, 48)
WM_T2, GM_T2, CSF_T2 = 110.0, 140.0, 900.0
N_ATLAS_ROIS = 6


def synthesize_session(rng, sub_offset, ses_noise):
    """One session's (t2map, feta labels, atlas labels)."""
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in SHAPE], indexing="ij")
    r = np.sqrt(z**2 + y**2 + x**2)
    feta = np.zeros(SHAPE, np.int16)
    feta[r < 0.9] = 1          # CSF shell
    feta[r < 0.75] = 2         # GM
    feta[r < 0.55] = 3         # WM
    t2 = np.zeros(SHAPE, np.float32)
    t2[feta == 1] = CSF_T2
    t2[feta == 2] = GM_T2 + sub_offset
    t2[feta == 3] = WM_T2 + sub_offset
    t2 *= 1.0 + rng.normal(0, 0.03, SHAPE).astype(np.float32) + ses_noise
    # atlas: angular sectors inside the brain
    theta = np.arctan2(y, x)
    atlas = np.where(r < 0.75,
                     1 + ((theta + np.pi) / (2 * np.pi) * N_ATLAS_ROIS).astype(int)
                     % N_ATLAS_ROIS, 0).astype(np.int16)
    return t2, feta, atlas


def draw_figures(out_dir: str, df: pd.DataFrame, cov: pd.DataFrame, a, b, reg: dict,
                 rng) -> list:
    """The notebook's figures: CoV boxplots, the session regression,
    WM/GM violins, T2 and residual montages, per-tissue relaxation curves."""
    from ..analysis.figures import (cov_boxplot, map_montage, pearson_scatter,
                                    relaxation_curves, tissue_violin)

    cov_path = os.path.join(out_dir, "cov_boxplot.png")
    cov_boxplot({sub: g["cov"].to_numpy() for sub, g in cov.groupby("sub")},
                cov_path, title="inter-session CoV per subject (GM ROIs)")
    pearson_path = os.path.join(out_dir, "pearson_ses.png")
    pearson_scatter(a, b, pearson_path,
                    xlabel="ses-01 ROI T2 (ms)", ylabel="ses-02 ROI T2 (ms)",
                    title=f"r={reg['r']:.3f} p={reg['pvalue']:.2g}")
    violin_path = os.path.join(out_dir, "tissue_violin.png")
    tissue_violin(df[df["roi"].isin(["wm", "gm"])], violin_path)

    t2, feta, _ = synthesize_session(rng, 0.0, 0.0)
    map_path = map_montage(t2, os.path.join(out_dir, "t2map_montage.png"),
                           mask=feta > 0, label="T2 (ms)", title="fitted T2 map")
    residual = rng.normal(0, 2.0, t2.shape).astype(np.float32)
    res_path = map_montage(np.abs(residual), os.path.join(out_dir, "resmap_montage.png"),
                           mask=feta > 0, label="|residual|", title="fit residual map")

    tes = np.asarray([114.0, 202.0, 299.0])
    k0 = 1000.0
    roi_means, roi_stds, fits = {}, {}, {}
    for name, cls in (("wm", 3), ("gm", 2), ("csf", 1)):
        vox_t2 = t2[feta == cls]
        sig = k0 * np.exp(-tes[None, :] / vox_t2[:, None])
        roi_means[name] = sig.mean(0)
        roi_stds[name] = sig.std(0)
        fits[name] = (k0, float(vox_t2.mean()))
    curves_path = relaxation_curves(
        tes, roi_means, os.path.join(out_dir, "relaxation_curves.png"),
        fits=fits, roi_stds=roi_stds, title="per-tissue relaxation")
    return [cov_path, pearson_path, violin_path, map_path, res_path, curves_path]


def main(out_dir=None, device="cuda", figures: bool = True) -> pd.DataFrame:
    """Run the analysis with the ROI tables on ``device``; returns the
    per-(sub, ses, roi) table of mean T2 (also written as
    ``roi_t2_table.tsv`` in ``out_dir``)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "ft2_invivo_demo")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    rows = []
    session_means = {}
    atlas_labels = [{"index": i, "name": f"ROI-{i}"} for i in range(1, N_ATLAS_ROIS + 1)]
    for si, sub in enumerate(SUBJECTS):
        for ses in SESSIONS:
            t2, feta, atlas = synthesize_session(
                rng, sub_offset=5.0 * si, ses_noise=rng.normal(0, 0.01))
            # per-atlas-ROI GM stats (HO-style intersection, reference
            # utils/ada_utils.py:162-214) + per-FeTA-tissue stats
            df_roi = t2_per_atlas_roi(t2, feta, atlas, atlas_labels, tissue_class=2,
                                      device=device)
            df_tis = t2_per_tissue_feta(t2, feta, device=device)
            for _, row in df_roi.iterrows():
                rows.append({"sub": sub, "ses": ses, "roi": row["roi"],
                             "mean": row["mean"], "tissue": "gm"})
            for _, row in df_tis.iterrows():
                rows.append({"sub": sub, "ses": ses, "roi": row["tissue"],
                             "mean": row["mean"], "tissue": row["tissue"]})
            session_means[(sub, ses)] = df_roi["mean"].to_numpy()

    df = pd.DataFrame(rows)
    table_path = os.path.join(out_dir, "roi_t2_table.tsv")
    df.to_csv(table_path, sep="\t", index=False)

    # CoV across sessions per (sub, roi); Wilcoxon and Pearson between the
    # two sessions' ROI means (subjects pooled)
    cov = cov_by_group(df[df["tissue"] == "gm"], value_col="mean",
                       roi_col="roi", repeat_col="ses", within=["sub"])
    a = np.concatenate([session_means[(s, "ses-01")] for s in SUBJECTS])
    b = np.concatenate([session_means[(s, "ses-02")] for s in SUBJECTS])
    w = paired_wilcoxon(a, b)
    reg = pearson_regression(a, b)

    print(df.groupby(["roi"])["mean"].describe().loc[["wm", "gm", "csf"]])
    print(f"\nWilcoxon ses-01 vs ses-02: W={w['statistic']:.1f} p={w['pvalue']:.3f}")
    print(f"Pearson ses-01 vs ses-02: r={reg['r']:.4f} slope={reg['slope']:.3f}")
    paths = [table_path]
    if figures:
        paths += draw_figures(out_dir, df, cov, a, b, reg, rng)
    print(f"\nartifacts in {out_dir}:")
    for p in paths:
        print(" ", p)
    return df


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-figures", dest="figures", action="store_false")
    args = ap.parse_args()
    main(args.out_dir, device=args.device, figures=args.figures)
