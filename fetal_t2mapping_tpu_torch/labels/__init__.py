"""Labels and masks: the SynthSeg U-Net (``unet3d``, its S2D conv
``conv_s2d``, the runner ``synthseg``), the Keras-weight converter
``convert_synthseg`` (h5py, imported when it runs), brain masks, the FeTA
remap and the phantom's sphere labels."""

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
