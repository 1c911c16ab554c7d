"""Publication-style figures for reproducibility analysis (host; a copy of
``fetal_t2mapping_tpu.analysis.figures``).

Generic versions of the reference's notebook figures (utils/ada_utils.py:
218-883): CoV boxplots with pairwise Wilcoxon annotations, Pearson
scatter/regression panels, per-tissue violin plots and T2 boxplots. All take
tidy DataFrames (from analysis.stats / analysis.roi) instead of hardcoded
subject lists, and write PNGs.

matplotlib is imported when a figure is drawn, not with this module: the
analysis runs where matplotlib is absent, and drawing there raises
ModuleNotFoundError.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd

from .stats import paired_wilcoxon, pearson_regression


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _aligned_pair(a, b):
    """Align two samples for a PAIRED test. pandas Series pair on their index
    (ROI/subject identity); plain arrays pair positionally only when equal
    length — truncating to min(len) would silently pair the wrong rows."""
    if isinstance(a, pd.Series) and isinstance(b, pd.Series):
        common = a.index.intersection(b.index)
        return a.loc[common].to_numpy(float), b.loc[common].to_numpy(float)
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if len(a) != len(b):
        return None, None
    return a, b


def cov_boxplot(groups: Dict[str, np.ndarray], out_path: str,
                title: str = "Coefficient of variation",
                annotate_wilcoxon: bool = True) -> str:
    """Boxplot of CoV distributions per group with pairwise Wilcoxon p-values.

    Pass pandas Series (indexed by ROI/subject) to get identity-aligned
    pairing; unequal-length plain arrays get no annotation for that pair.
    """
    plt = _pyplot()
    names = list(groups)
    data = [np.asarray(groups[n], float) for n in names]
    fig, ax = plt.subplots(figsize=(2 + 1.6 * len(names), 6))
    ax.boxplot(data, tick_labels=names, showmeans=True)
    ax.set_ylabel("CoV (%)")
    ax.set_title(title)
    ax.grid(True, axis="y", alpha=0.4)
    if annotate_wilcoxon and len(names) >= 2:
        y = max(np.nanmax(d) if len(d) else 0 for d in data)
        step = 0.08 * max(y, 1.0)
        level = y + step
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                ai, bj = _aligned_pair(groups[names[i]], groups[names[j]])
                if ai is not None and len(ai) >= 3:
                    res = paired_wilcoxon(ai, bj)
                    ax.plot([i + 1, j + 1], [level, level], "k-", lw=0.8)
                    ax.text((i + j) / 2 + 1, level, f"p={res['pvalue']:.3g}",
                            ha="center", va="bottom", fontsize=8)
                    level += step
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
    return out_path


def pearson_scatter(x: np.ndarray, y: np.ndarray, out_path: str,
                    xlabel: str = "repetition A", ylabel: str = "repetition B",
                    title: str = "") -> str:
    """Scatter + OLS regression + identity line, annotated with r/p."""
    plt = _pyplot()
    reg = pearson_regression(x, y)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(x, y, s=14, alpha=0.7)
    lim = [np.nanmin([x, y]), np.nanmax([x, y])]
    ax.plot(lim, lim, "k--", lw=0.8, label="identity")
    if np.isfinite(reg["slope"]):
        xs = np.linspace(lim[0], lim[1], 10)
        ax.plot(xs, reg["slope"] * xs + reg["intercept"], "r-", lw=1.2,
                label=f"fit: r={reg['r']:.3f}, p={reg['pvalue']:.2g}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    ax.grid(True, alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
    return out_path


def tissue_violin(df: pd.DataFrame, out_path: str, value_col: str = "mean",
                  tissue_col: str = "tissue", unit_col: str = "sub",
                  title: str = "T2 per tissue") -> str:
    """Violin plot of per-unit ROI T2 for each tissue class."""
    plt = _pyplot()
    tissues = sorted(df[tissue_col].unique())
    data = [df[df[tissue_col] == t][value_col].dropna().to_numpy() for t in tissues]
    fig, ax = plt.subplots(figsize=(2 + 1.6 * len(tissues), 6))
    parts = ax.violinplot([d if len(d) else [np.nan] for d in data], showmedians=True)
    ax.set_xticks(np.arange(1, len(tissues) + 1))
    ax.set_xticklabels(tissues)
    ax.set_ylabel("T2 (ms)")
    ax.set_title(title)
    ax.grid(True, axis="y", alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
    return out_path


def _qmri_cmap():
    """cmcrameri 'navia' when installed (the reference notebooks' map
    colormap); perceptually-uniform 'cividis' otherwise."""
    try:
        from cmcrameri import cm  # type: ignore

        return cm.navia
    except ImportError:
        import matplotlib

        return matplotlib.colormaps["cividis"]


def map_montage(data: np.ndarray, out_path: str, *, n_slices: int = 4,
                axis: int = 0, vmin: float = 0.0, vmax: Optional[float] = None,
                mask: Optional[np.ndarray] = None, label: str = "T2 (ms)",
                title: str = "") -> str:
    """Colormapped slice montage of a parameter/residual map with colorbar.

    The reference's notebook map renders (20240910_ada_jmri.ipynb, cmcrameri
    navia): evenly spaced slices along ``axis``, masked voxels transparent.
    """
    plt = _pyplot()
    data = np.asarray(data, np.float32)
    if mask is not None:
        data = np.where(np.asarray(mask) > 0, data, np.nan)
    if vmax is None:
        finite = data[np.isfinite(data) & (data != 0)]
        vmax = float(np.percentile(finite, 99)) if finite.size else 1.0
    n_slices = min(n_slices, data.shape[axis])
    picks = np.linspace(0, data.shape[axis] - 1, n_slices + 2)[1:-1].astype(int)
    fig, axes = plt.subplots(1, n_slices, figsize=(3.2 * n_slices, 3.6))
    axes = np.atleast_1d(axes)
    cmap = _qmri_cmap()
    im = None
    for ax, idx in zip(axes, picks):
        sl = np.take(data, idx, axis=axis)
        im = ax.imshow(sl, cmap=cmap, vmin=vmin, vmax=vmax,
                       interpolation="nearest")
        ax.set_title(f"slice {idx}", fontsize=9)
        ax.axis("off")
    fig.colorbar(im, ax=list(axes), label=label, shrink=0.85)
    if title:
        fig.suptitle(title)
    plt.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def relaxation_curves(tes: Sequence[float],
                      roi_means: Dict[str, np.ndarray], out_path: str, *,
                      fits: Optional[Dict[str, tuple]] = None,
                      roi_stds: Optional[Dict[str, np.ndarray]] = None,
                      gt: Optional[Dict[str, float]] = None,
                      ncols: int = 3, title: str = "") -> str:
    """Per-ROI signal-relaxation panels: measured mean (+/- std) per TE with
    the fitted k*exp(-TE/T2) overlay and its R^2.

    The reference's in-vivo relaxation-curve cells and in-vitro per-sphere
    decay plots (20240910_ada_jmri.ipynb / 20240924_..._invitro.ipynb).
    fits maps roi -> (k, t2); gt optionally annotates a ground-truth T2.
    """
    plt = _pyplot()
    tes = np.asarray(tes, float)
    names = list(roi_means)
    nrows = -(-len(names) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.6 * ncols, 3.0 * nrows),
                             sharex=True, squeeze=False)
    tt = np.linspace(0.0, tes.max() * 1.15, 200)
    for ax, name in zip(axes.ravel(), names):
        means = np.asarray(roi_means[name], float)
        if roi_stds is not None and name in roi_stds:
            ax.errorbar(tes, means, yerr=np.asarray(roi_stds[name], float),
                        fmt="o", ms=4, capsize=2, label="measured")
        else:
            ax.plot(tes, means, "o", ms=4, label="measured")
        note = ""
        if fits and name in fits:
            k, t2 = fits[name][:2]
            pred = k * np.exp(-tes / t2)
            ss_res = float(np.sum((means - pred) ** 2))
            ss_tot = float(np.sum((means - means.mean()) ** 2))
            r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
            ax.plot(tt, k * np.exp(-tt / t2), "-", lw=1.2,
                    label=f"fit T2={t2:.0f} ms")
            note = f"  R²={r2:.4f}"
        if gt and name in gt:
            note += f"  GT {gt[name]:.0f} ms"
        ax.set_title(f"{name}{note}", fontsize=9)
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
    for ax in axes.ravel()[len(names):]:
        ax.axis("off")
    fig.supxlabel("TE (ms)")
    fig.supylabel("signal")
    if title:
        fig.suptitle(title)
    plt.tight_layout()
    plt.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def t2_boxplot(df: pd.DataFrame, out_path: str, value_col: str = "mean",
               group_col: str = "roi", title: str = "ROI T2") -> str:
    plt = _pyplot()
    groups = sorted(df[group_col].unique())
    data = [df[df[group_col] == g][value_col].dropna().to_numpy() for g in groups]
    fig, ax = plt.subplots(figsize=(2 + 0.8 * len(groups), 6))
    ax.boxplot(data, tick_labels=groups)
    ax.set_ylabel("T2 (ms)")
    ax.set_title(title)
    ax.tick_params(axis="x", rotation=75)
    ax.grid(True, axis="y", alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
    return out_path
