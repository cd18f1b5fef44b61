from . import ops, ref
from .ops import causal_conv1d

__all__ = ["ops", "ref", "causal_conv1d"]
