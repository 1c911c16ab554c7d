from .volume import Volume
from .stack import EchoStack
from . import nifti

__all__ = ["Volume", "EchoStack", "nifti"]
