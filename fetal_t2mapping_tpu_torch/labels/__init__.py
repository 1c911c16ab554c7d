from .feta import synthseg_to_feta, FETA_CLASS_NAMES
from .masks import mask_from_labels, extract_brain, phantom_mask
from .phantom import phantom_labels_from_seeds
from .synthseg import SynthSegRunner

__all__ = [
    "synthseg_to_feta",
    "FETA_CLASS_NAMES",
    "mask_from_labels",
    "extract_brain",
    "phantom_mask",
    "phantom_labels_from_seeds",
    "SynthSegRunner",
]
