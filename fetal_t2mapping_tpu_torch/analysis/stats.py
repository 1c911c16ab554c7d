"""Reproducibility statistics: CoV, paired tests, Pearson regressions (host
numpy, pandas and scipy; a copy of ``fetal_t2mapping_tpu.analysis.stats``).

Generic, table-driven equivalents of the reference's figure-specific code
(utils/ada_utils.py:218-701): coefficient-of-variation of ROI T2 across
repetitions (runs / sessions / subjects / field strengths), Wilcoxon paired
tests between groups, and Pearson correlation/regression between paired ROI
measurements.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
from scipy import stats


def coefficient_of_variation(values: np.ndarray) -> float:
    """CoV in percent: 100 * std / mean (nan-aware)."""
    v = np.asarray(values, float)
    m = np.nanmean(v)
    if not np.isfinite(m) or m == 0:
        return np.nan
    return float(100.0 * np.nanstd(v) / m)


def cov_by_group(df: pd.DataFrame, value_col: str = "mean", roi_col: str = "roi",
                 repeat_col: str = "ses", within: Optional[Sequence[str]] = None) -> pd.DataFrame:
    """Per-ROI CoV of ``value_col`` across repetitions.

    ``within`` columns (e.g. ['sub']) define the unit inside which the
    repetitions vary; the result has one CoV row per (within..., roi).
    """
    keys = list(within or []) + [roi_col]
    rows = []
    for key, g in df.groupby(keys):
        key = key if isinstance(key, tuple) else (key,)
        if g[repeat_col].nunique() < 2:
            continue
        rows.append(dict(zip(keys, key), cov=coefficient_of_variation(g[value_col].to_numpy()),
                         n_repeats=g[repeat_col].nunique()))
    return pd.DataFrame(rows)


def paired_wilcoxon(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """Wilcoxon signed-rank test between paired measurements."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 3:
        return {"statistic": np.nan, "pvalue": np.nan, "n": int(ok.sum())}
    res = stats.wilcoxon(a[ok], b[ok])
    return {"statistic": float(res.statistic), "pvalue": float(res.pvalue), "n": int(ok.sum())}


def pearson_regression(x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """Pearson r + OLS line between paired ROI values (nan-aware)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    ok = np.isfinite(x) & np.isfinite(y)
    if ok.sum() < 3:
        return {"r": np.nan, "pvalue": np.nan, "slope": np.nan,
                "intercept": np.nan, "n": int(ok.sum())}
    lr = stats.linregress(x[ok], y[ok])
    return {"r": float(lr.rvalue), "pvalue": float(lr.pvalue),
            "slope": float(lr.slope), "intercept": float(lr.intercept),
            "n": int(ok.sum())}


def pairwise_repeatability(df: pd.DataFrame, value_col: str = "mean", roi_col: str = "roi",
                           unit_cols: Sequence[str] = ("sub",), repeat_col: str = "ses") -> pd.DataFrame:
    """All pairs of repetitions inside each unit, aligned on ROI.

    Feeds the Pearson inter-run/inter-session/inter-subject regressions
    (utils/ada_utils.py:360-701): each output row is one ROI measured in two
    repetitions of the same unit.
    """
    rows = []
    for key, g in df.groupby(list(unit_cols)):
        reps = sorted(g[repeat_col].unique())
        for i in range(len(reps)):
            for j in range(i + 1, len(reps)):
                a = g[g[repeat_col] == reps[i]].set_index(roi_col)[value_col]
                b = g[g[repeat_col] == reps[j]].set_index(roi_col)[value_col]
                common = a.index.intersection(b.index)
                for roi in common:
                    rows.append({
                        **dict(zip(unit_cols, key if isinstance(key, tuple) else (key,))),
                        "roi": roi, "rep_a": reps[i], "rep_b": reps[j],
                        "value_a": float(np.atleast_1d(a[roi])[0]),
                        "value_b": float(np.atleast_1d(b[roi])[0]),
                    })
    return pd.DataFrame(rows)
