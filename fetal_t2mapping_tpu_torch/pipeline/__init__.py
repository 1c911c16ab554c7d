from .recon_pipeline import process_qmri, run_segmentation
from .t2map_pipeline import process_t2maps

__all__ = ["process_qmri", "process_t2maps", "run_segmentation"]
