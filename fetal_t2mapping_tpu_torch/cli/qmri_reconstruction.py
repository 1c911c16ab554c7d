"""CLI: qMRI reconstruction / derivative generation on a GPU
(reference run_qmri_reconstruction.py:94-141).

The flags of ``fetal_t2mapping_tpu.cli.qmri_reconstruction``, with
``--synthseg`` choices ``subprocess``, ``torch`` and ``fake``, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
``--prewarm`` is accepted for the reference's interface and runs no step
(``utils.prewarm``); ``--mesh N`` spreads the registrations and the
torch-mode U-Net over the first N CUDA devices.

Example:
    python -m fetal_t2mapping_tpu_torch.cli.qmri_reconstruction --path /data/qMRI \\
        --csv prj-004 --in_vivo --lf --synthseg fake
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .. import config as C
from ..labels.synthseg import SynthSegRunner
from ..pipeline.recon_pipeline import process_qmri
from ..utils.metadata import set_metadata


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="GPU qMRI Reconstruction (PyTorch + CUDA)",
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--path", type=str, required=True,
                        help="Path to general directory ../qMRI/")
    parser.add_argument("--csv", type=str, nargs="+", required=True,
                        help="Metadata CSV log file name(s) or project name (prj-00X)")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--in_vivo", action="store_true")
    group.add_argument("--in_vitro", action="store_true")
    group2 = parser.add_mutually_exclusive_group(required=True)
    group2.add_argument("--lf", action="store_true", help="0.55 T data")
    group2.add_argument("--hf", action="store_true", help="1.5 T data")
    parser.add_argument("--seeds", type=str, default=C.DEFAULT_PHANTOM_SEEDS_KEY,
                        choices=sorted(C.PHANTOM_SEEDS),
                        help="Phantom seed set (in-vitro only)")
    parser.add_argument("--synthseg", type=str, default="subprocess",
                        choices=["subprocess", "torch", "fake"],
                        help="Segmentation backend ('torch' runs converted weights "
                             "on --device; 'fake' needs no FreeSurfer)")
    parser.add_argument("--masked_metric", action="store_true",
                        help="Restrict registration metrics to an automatic "
                             "fixed-image signal mask (threshold+fill+dilate+erode "
                             "per slice) — the reference's SetMetricFixedMask design")
    parser.add_argument("--prewarm", action="store_true",
                        help="Accepted for the reference's interface; runs no step (no "
                             "warm-up made stage 2 faster on the GPU; utils/prewarm)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu (the plain "
                             "PyTorch path)")
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="Shard device work over the first N CUDA devices: "
                             "registration metric samples and torch-mode SynthSeg "
                             "inference")
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = parse_arguments(argv)
    if not os.path.exists(args.path):
        print(f"Error: path does not exist: {args.path}", file=sys.stderr)
        return 1
    bids_path = os.path.join(args.path, "projects/")
    csv_path = os.path.join(args.path, "dicom/logs/")
    from ..parallel.mesh import mesh_from_flag

    try:
        mesh = mesh_from_flag(args.mesh)
    except ValueError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    metadata = set_metadata(csv_path, args.csv, args.lf)
    process_qmri(
        bids_path, metadata,
        in_vivo=args.in_vivo,
        low_field=args.lf,
        synthseg=SynthSegRunner(mode=args.synthseg, device=args.device),
        seeds_key=args.seeds,
        registration_kwargs=dict(fixed_mask="auto") if args.masked_metric else None,
        mesh=mesh,
        prewarm=args.prewarm,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
