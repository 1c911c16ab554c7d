from .signal import gauss_model, gauss_rician_model, predict_signal, MODEL_NAMES
from .init import grid_init, loglinear_init
from .solver import fit_batch, fit_batch_multistart, fit_batch_traced, FitResult
from .fused_fit import fit_fused
from .t2map import fit_stack, T2FitOutput
from .volume_fit import fit_volume, VolumeFitResult

__all__ = [
    "gauss_model",
    "gauss_rician_model",
    "predict_signal",
    "MODEL_NAMES",
    "grid_init",
    "loglinear_init",
    "fit_batch",
    "fit_batch_multistart",
    "fit_batch_traced",
    "FitResult",
    "fit_fused",
    "fit_stack",
    "T2FitOutput",
    "fit_volume",
    "VolumeFitResult",
]
