"""Stage 2 pipeline, step 4: SynthSeg labels per session.

The counterpart of ``run_segmentation`` in
``fetal_t2mapping_tpu.pipeline.recon_pipeline`` (reference
run_qmri_reconstruction.py, utils/qmri_utils.py:424-466), over the port's
metadata rows (a list of dicts, as ``utils.metadata.set_metadata`` returns
them). The other stage-2 steps are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .. import config as C
from ..labels.synthseg import SynthSegRunner
from ..utils.bids import mk_bids_dir
from .t2map_pipeline import _groups


def run_segmentation(metadata: List[Dict], bids_path: str,
                     runner: Optional[SynthSegRunner] = None) -> None:
    """Step 4: SynthSeg labels per (prj, sub, ses) recon dir, written to the
    session's ``recon_1mm_synthseg`` derivative dir."""
    runner = runner or SynthSegRunner()
    for (prj, sub, ses), _ in _groups(metadata, "prj", "sub", "ses"):
        input_dir = os.path.join(bids_path, prj, "derivatives", C.RECON_DIRNAME, sub, ses, "anat")
        output_dir = mk_bids_dir(bids_path, prj, "derivatives", C.SYNTHSEG_DIRNAME, sub, ses, "anat")
        runner.run(input_dir, output_dir)
