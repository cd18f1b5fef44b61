from . import ops, ref
from .ops import rms_norm

__all__ = ["ops", "ref", "rms_norm"]
