"""Acquisition metadata: CSV session logs -> a list of row dicts.

Every pipeline stage is driven by per-session CSV logs holding one row per
acquisition (sub/ses/run/EchoTime/orientation/...). Same shortlists and
``set_metadata`` semantics as ``fetal_t2mapping_tpu.utils.metadata``, read
with the stdlib ``csv`` module instead of pandas. Each column is typed the
way ``pandas.read_csv`` infers it: all integers -> int, all numbers ->
float, otherwise str; an empty cell is None. ``csv2df`` is the reference's
pandas loader of one log.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

# Study shortlists: sessions selected for the published analyses.
PRJ_004_LF: List[str] = [
    "2024083017_17510000.csv", "2024090320_55420000.csv", "2024090618_37050000.csv",
    "2024090811_14320000.csv", "2024091017_53530000_1.csv", "2024091017_53530000_2.csv",
    "2024091020_45220000.csv", "2024091320_23400000.csv", "2024091321_22550000.csv",
    "2024091322_27490000.csv", "2024092720_10110000.csv", "2024092719_10310000.csv",
    "2024102120_48480000.csv",
]
PRJ_004_HF: List[str] = [
    "2024083019_26300000.csv", "2024090322_28560000.csv", "2024090619_26370000.csv",
    "2024090812_21470000.csv", "2024091021_57280000.csv", "2024091319_13240000.csv",
    "2024091318_13560000.csv", "2024092721_25410000.csv", "2024102616_18560000.csv",
    "2024102122_28450000.csv",
]
PRJ_003_LF: List[str] = ["20240806_30540000_1.csv"]
PRJ_002_LF: List[str] = ["20240527_095111_2.csv"]
PRJ_002_HF: List[str] = ["20240609_50140000_2.csv"]


def project_csvs(project: str, low_field: bool) -> List[str]:
    table = {
        ("prj-004", True): PRJ_004_LF,
        ("prj-004", False): PRJ_004_HF,
        ("prj-003", True): PRJ_003_LF,
        ("prj-002", True): PRJ_002_LF,
        ("prj-002", False): PRJ_002_HF,
    }
    key = (project, low_field)
    if key not in table:
        raise ValueError(f"no session shortlist for {project} at "
                         f"{'0.55T' if low_field else '1.5T'}")
    return list(table[key])


def _typed_column(cells: List[str]) -> list:
    present = [c for c in cells if c != ""]
    for conv in (int, float):
        try:
            typed = {c: conv(c) for c in present}
        except ValueError:
            continue
        return [typed[c] if c != "" else None for c in cells]
    return [c if c != "" else None for c in cells]


def read_csv(csv_path: str) -> List[Dict]:
    """One dict per data row, keyed by the header, with typed columns."""
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return []
    header, body = rows[0], rows[1:]
    columns = [_typed_column([r[j] if j < len(r) else "" for r in body])
               for j in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)] if body else []


def csv2df(csv_path: str):
    """One session log as a ``pandas.DataFrame`` (the reference's loader;
    pandas is imported here, so importing this module does not need it)."""
    import pandas as pd

    return pd.read_csv(csv_path)


def set_metadata(csv_path: str, csvs: Sequence[str], low_field: bool) -> List[Dict]:
    """Load and concatenate session logs.

    ``csvs`` is either explicit CSV filenames or a single project name
    ('prj-002'/'prj-003'/'prj-004') selecting that study's shortlist.
    """
    expanded = []
    for c in csvs:
        if c.startswith("prj-"):
            expanded.extend(project_csvs(c, low_field))
        else:
            expanded.append(c)
    bad = [c for c in expanded if not c.lower().endswith(".csv")]
    if not expanded or bad:
        raise ValueError(
            f"{list(csvs)!r} is neither metadata CSV log file(s) nor known "
            "project name(s) (prj-002 / prj-003 / prj-004)")
    rows: List[Dict] = []
    for c in expanded:
        rows.extend(read_csv(os.path.join(csv_path, c)))
    return rows
