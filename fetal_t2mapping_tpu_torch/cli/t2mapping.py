"""CLI: voxel-wise T2 mapping on a GPU (reference run_t2mapping.py:483-576).

The flags of ``fetal_t2mapping_tpu.cli.t2mapping`` without ``--mesh``,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch fit).

Example:
    python -m fetal_t2mapping_tpu_torch.cli.t2mapping --path /data/qMRI \\
        --csv prj-003 --in_vitro --gaussian --lf --sim 1
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .. import config as C
from ..pipeline.t2map_pipeline import process_t2maps
from ..utils.metadata import set_metadata


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="GPU T2 Mapping (PyTorch + CUDA)",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--path", type=str, required=True,
                        help="Path to general directory ../qMRI/")
    parser.add_argument("--csv", type=str, nargs="+", required=True,
                        help=("Either:\n"
                              "  (1) metadata CSV log file name(s)\n"
                              "  (2) a project name (prj-00X) to process its shortlist"))
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--in_vivo", action="store_true", help="Process in vivo data")
    group.add_argument("--in_vitro", action="store_true", help="NIST phantom, full maps")
    group.add_argument("--in_vitro_fast", action="store_true", help="NIST phantom, ROI-only")
    group2 = parser.add_mutually_exclusive_group(required=True)
    group2.add_argument("--gaussian", action="store_true")
    group2.add_argument("--gaussian_rician", action="store_true")
    group2.add_argument("--rician", action="store_true")
    group3 = parser.add_mutually_exclusive_group(required=True)
    group3.add_argument("--lf", action="store_true", help="0.55 T data")
    group3.add_argument("--hf", action="store_true", help="1.5 T data")
    parser.add_argument("--sim", type=str, required=True, help="T2 fitting ID")
    parser.add_argument("--TEs", nargs="+", type=int,
                        help="TEs to fit (defaults: lf [114,202,299], hf [115,202,299])")
    parser.add_argument("--no_prior", action="store_true", default=False,
                        help="Per-voxel M0 lower bound = signal at min TE")
    parser.add_argument("--norm", action="store_true", default=False,
                        help="Normalize T2w signal per voxel (not recommended)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the fit: cuda (the CUDA kernel, "
                             "default) or cpu (the plain PyTorch version)")
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = parse_arguments(argv)
    if not os.path.exists(args.path):
        print(f"Error: path does not exist: {args.path}", file=sys.stderr)
        return 1

    bids_path = os.path.join(args.path, "projects/")
    csv_path = os.path.join(args.path, "dicom/logs/")
    low_field = args.lf
    tes = args.TEs or C.default_tes(low_field)
    model = ("gaussian" if args.gaussian else
             "gaussian_rician" if args.gaussian_rician else "rician")
    if args.norm:
        print("Warning: fitting with normalization is not optimal!", file=sys.stderr)

    cfg = C.fit_config(model, low_field, prior=not args.no_prior, norm=args.norm)
    metadata = set_metadata(csv_path, args.csv, low_field)
    process_t2maps(
        metadata, bids_path, tes, cfg,
        phantom=args.in_vitro or args.in_vitro_fast,
        low_field=low_field,
        fast=args.in_vitro_fast,
        sim=args.sim,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
