from .recon_pipeline import run_segmentation
from .t2map_pipeline import process_t2maps

__all__ = ["process_t2maps", "run_segmentation"]
