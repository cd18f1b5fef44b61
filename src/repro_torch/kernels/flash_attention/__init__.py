from . import ops, ref
from .ops import flash_attention

__all__ = ["ops", "ref", "flash_attention"]
