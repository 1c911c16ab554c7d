from .convergence import save_convergence_plots

__all__ = ["save_convergence_plots"]
