from .synthseg import SynthSegRunner

__all__ = ["SynthSegRunner"]
