"""Convergence observability figures.

The three convergence-study artifacts of
``fetal_t2mapping_tpu.analysis.convergence`` (reference
utils/t2map_utils.py:115-292): sampled-voxel loss curves, step-size curves
(log-y), and an iterations-vs-final-loss scatter, all colored by fitted T2.

matplotlib is imported when the figures are drawn, not with this module:
the fit runs where matplotlib is absent, and asking for figures there
raises ModuleNotFoundError instead of skipping them quietly. Figures use
the object-oriented API (Figure, no pyplot registry), so rendering is
thread-safe and runs on the pipeline's plot worker.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

# PNG compress_level 1: these are diagnostic artifacts, the faster encode
# matters more than +15% file size
_PNG_KW = dict(pil_kwargs={"compress_level": 1})


def save_convergence_plots(ada_path: str, traces: Dict[str, np.ndarray],
                           trace_t2: np.ndarray, n_iter: np.ndarray,
                           final_fun: np.ndarray, all_t2: np.ndarray,
                           sub: str, ses: str, sim: str, fit: str) -> list:
    """Write the three convergence figures; returns the file paths."""
    from matplotlib import colormaps
    from matplotlib.cm import ScalarMappable
    from matplotlib.collections import LineCollection
    from matplotlib.colors import Normalize
    from matplotlib.figure import Figure

    cmap = colormaps["jet"]

    def norm_for(values):
        vmin, vmax = float(np.min(values)), float(np.max(values))
        if vmin == vmax:
            vmax = vmin + 1.0
        return Normalize(vmin=vmin, vmax=vmax)

    def new_axes(figsize):
        fig = Figure(figsize=figsize)
        return fig, fig.add_subplot()

    def colorbar(fig, ax, norm):
        sm = ScalarMappable(cmap=cmap, norm=norm)
        sm.set_array([])
        fig.colorbar(sm, ax=ax).set_label("T2 Value")

    def trace_lines(ax, series, active, norm):
        segs, colors = [], []
        for j in range(series.shape[1]):
            n_act = max(int(active[:, j].sum()), 1)
            segs.append(np.column_stack([np.arange(n_act), series[:n_act, j]]))
            colors.append(cmap(norm(trace_t2[j])))
        ax.add_collection(LineCollection(segs, colors=colors, linewidths=1.5))
        ax.autoscale_view()

    os.makedirs(ada_path, exist_ok=True)
    paths = []
    f_val = np.asarray(traces["f_val"])
    step = np.asarray(traces["step_size"])
    active = np.asarray(traces["active"])
    norm = norm_for(trace_t2)

    # 1. loss curves
    fig, ax = new_axes((12, 6))
    trace_lines(ax, f_val, active, norm)
    colorbar(fig, ax, norm)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Objective Function Value (Loss)")
    ax.set_title("Convergence of Sampled Voxels Colored by T2 Value")
    ax.grid(True)
    p = os.path.join(ada_path, f"convergence_sampled_voxels_by_t2_{sub}_{ses}_sim-{sim}_{fit}.png")
    fig.savefig(p, **_PNG_KW)
    paths.append(p)

    # 2. step-size curves (log y)
    fig, ax = new_axes((12, 6))
    trace_lines(ax, np.maximum(step, 1e-12), active, norm)
    colorbar(fig, ax, norm)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Step Size")
    ax.set_yscale("log")
    ax.set_title("Step-Size Convergence of Sampled Voxels Colored by T2 Value")
    ax.grid(True)
    p = os.path.join(ada_path, f"step_size_convergence_sampled_voxels_by_t2_{sub}_{ses}_sim-{sim}_ada-{fit}.png")
    fig.savefig(p, **_PNG_KW)
    paths.append(p)

    # 3. iterations vs final loss scatter, deterministically subsampled to
    # 10k points (an s=4 scatter saturates to solid ink well below that,
    # while draw time keeps growing linearly)
    n_iter, final_fun, all_t2 = (np.asarray(n_iter), np.asarray(final_fun),
                                 np.asarray(all_t2))
    if n_iter.size > 10_000:
        sel = np.random.default_rng(0).choice(n_iter.size, 10_000,
                                              replace=False)
        n_iter, final_fun, all_t2 = n_iter[sel], final_fun[sel], all_t2[sel]
    norm2 = norm_for(all_t2)
    fig, ax = new_axes((10, 8))
    ax.scatter(n_iter, final_fun, c=all_t2, cmap=cmap, norm=norm2, s=4)
    colorbar(fig, ax, norm2)
    ax.set_xlabel("Number of Iterations")
    ax.set_ylabel("Final Loss Function Value")
    ax.set_title("Final Number of Iterations vs Final Loss (Colored by T2)")
    ax.grid(True)
    p = os.path.join(ada_path, f"scatter_iterations_vs_loss_by_t2_{sub}_{ses}_sim-{sim}_ada-{fit}.png")
    fig.savefig(p, **_PNG_KW)
    paths.append(p)
    return paths
