from .convergence import save_convergence_plots
from .roi import roi_stats_per_label, t2_per_atlas_roi, FETA_LABELS

__all__ = ["save_convergence_plots", "roi_stats_per_label", "t2_per_atlas_roi", "FETA_LABELS"]
