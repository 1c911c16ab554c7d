"""Cold-start prewarm: kept for the reference's API, and runs no step.

The counterpart of ``fetal_t2mapping_tpu.utils.prewarm``. There the cost it
hides is a remote load per compiled TPU program, and a background thread
runs the stage-2 programs once on synthetic data while the inputs are
read. With eager PyTorch on one GPU the one-time costs are what a process
pays the first time it touches each piece (the CUDA context, the cuBLAS
handle, lazily loaded kernel modules), and stage 2's first device op comes
one input read after its start, so there is almost nothing to overlap.
Measured on an H100 in fresh processes (``chip_smoke.prewarm_study``,
PERF.md): a replay of the stage at the session's size, a replay at 32
voxels a side, the context and a cuBLAS handle, and the context alone each
made stage 2 slower or did not beat it. So ``start_recon_prewarm`` returns
a finished handle that ran no step, and ``process_qmri(prewarm=True)`` /
``qmri_reconstruction --prewarm`` keep the reference's interface and
results at no cost.

Usage::

    process_qmri(..., prewarm=True)        # or qmri_reconstruction --prewarm
    h = start_recon_prewarm(acq_geoms)     # h.done, h.steps == []
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..core.volume import Volume

log = logging.getLogger("fetal_t2mapping_tpu_torch.prewarm")


class PrewarmHandle:
    """Handle of a prewarm, with the reference's fields: ``steps`` (the
    steps that completed: none), ``error`` (None) and ``seconds`` (0).
    ``wait()`` returns at once."""

    def __init__(self):
        self.steps: List[str] = []
        self.error: Optional[BaseException] = None
        self.seconds: float = 0.0

    def wait(self, timeout: Optional[float] = None) -> "PrewarmHandle":
        return self

    @property
    def done(self) -> bool:
        return True


def start_recon_prewarm(acq_geoms: Dict[str, Volume], *, fixed_type: str = "ax",
                        n_echoes: int = 3, denoise: bool = True, high_res: float = 1.0,
                        registration_kwargs: Optional[dict] = None, labels: bool = True,
                        synthseg=None, device="cuda") -> PrewarmHandle:
    """The reference's entry point with its arguments: checks that
    ``acq_geoms`` (orientation -> geometry Volume) holds the fusion's fixed
    orientation and returns a finished :class:`PrewarmHandle`. It starts no
    thread and touches no device (see the module docstring)."""
    if fixed_type not in acq_geoms:
        raise ValueError(f"fixed_type {fixed_type!r} not in {sorted(acq_geoms)}")
    return PrewarmHandle()


def geoms_from_metadata(metadata: List[Dict], bids_path: str) -> Dict[str, Volume]:
    """One geometry-only Volume per orientation of the first (prj, sub, ses)
    in ``metadata`` (header reads only: a few hundred bytes per
    acquisition). Sessions of one protocol share geometry, so the first
    session's shapes stand for the run."""
    from .. import config as C
    from ..core import nifti
    from ..pipeline.t2map_pipeline import _groups
    from .bids import get_img_path

    geoms: Dict[str, Volume] = {}
    first = next(iter(_groups(metadata, "prj", "sub", "ses")), None)
    if first is None:
        return geoms
    for otype, o_md in _groups(first[1], "ImageOrientationPatientSTR"):
        path = get_img_path(bids_path, o_md[0], C.IN_DIRNAME)
        try:
            geoms[str(otype)] = nifti.read_header(path)
        except (FileNotFoundError, ValueError) as exc:
            log.warning("prewarm: cannot read header %s (%s)", path, exc)
    return geoms
