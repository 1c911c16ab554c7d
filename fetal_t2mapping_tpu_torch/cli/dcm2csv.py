"""CLI: DICOM check/ingest (reference run_dcm2csv.py:75-107).

The flags of ``fetal_t2mapping_tpu.cli.dcm2csv``; host code only, so no
``--device``. Writes ROOT/projects/ (BIDS NIfTIs and sidecars) and
ROOT/dicom/logs/<date>_<parent>.csv, which ``cli.qmri_reconstruction``
and ``cli.t2mapping`` read.

Example:
    python -m fetal_t2mapping_tpu_torch.cli.dcm2csv \\
        --path /data/qMRI/dicom/2024080610/30540000 --process
"""

from __future__ import annotations

import argparse
import os
import sys

import pandas as pd

from ..utils.dicom import read_dcm
from ..utils.ingest import (
    SIDE_CAR_KEYS,
    assign_bids,
    dcms2csv,
    get_dcms,
    get_metabids,
    run_dcm2niix,
)


def check_dicom(dicom_path: str) -> None:
    """Dry run: list every file with its series description.

    Walks recursively — the same traversal --process uses — so the dry run
    and the real ingest agree about what will be converted."""
    print("Put localizers and failed acquisitions in a separate folder first. "
          "Acquired sequences found:")
    for root, _, files in os.walk(dicom_path):
        for flnm in sorted(files):
            rel = os.path.relpath(os.path.join(root, flnm), dicom_path)
            try:
                ds = read_dcm(os.path.join(root, flnm))
                print(rel, ds.get("SeriesDescription", "?"))
            except Exception as e:  # noqa: BLE001 — a listing tool keeps going
                print(rel, f"<not DICOM: {e}>")


def process_dicom(dicom_path: str, bids_path: str, csv_path: str,
                  dcm_log_path: str, interactive: bool) -> None:
    dcms = get_dcms(dicom_path, structured=False)
    df = pd.DataFrame(dcms)
    print("========= DCMs parents and count =========")
    print(df.groupby("dcm_parent").size().reset_index(name="count"))
    df = assign_bids(dcms, dcm_log_path, interactive=interactive)
    run_dcm2niix(df, bids_path)
    df = get_metabids(df, SIDE_CAR_KEYS, bids_path)
    dcms2csv(csv_path, df)


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="DICOM ingest")
    parser.add_argument("--path", type=str, required=True,
                        help="Path to dicoms directory qMRI/dicom/YYYYMMDDHH/MMSS0000/")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--check", action="store_true", help="List DICOMs before processing")
    group.add_argument("--process", action="store_true", help="Convert + log DICOMs")
    parser.add_argument("--interactive", action="store_true",
                        help="Prompt per session before assigning BIDS ids")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    if not os.path.exists(args.path):
        print(f"Error: path does not exist: {args.path}", file=sys.stderr)
        return 1
    # root = everything above the LAST '/dicom/' path component ('dicom'
    # appearing inside other names, e.g. /home/medicomp, must not match)
    parts = os.path.abspath(args.path).split(os.sep)
    if "dicom" not in parts:
        print(f"Error: path must contain a 'dicom' directory: {args.path}",
              file=sys.stderr)
        return 1
    last = len(parts) - 1 - parts[::-1].index("dicom")
    root = os.sep.join(parts[:last]) or os.sep
    csv_path = os.path.join(root, "dicom/logs/")
    dcm_log_path = os.path.join(root, "dicom/logs/log_dcms.csv")
    bids_path = os.path.join(root, "projects/")
    if args.check:
        check_dicom(args.path)
    else:
        process_dicom(args.path, bids_path, csv_path, dcm_log_path, args.interactive)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
