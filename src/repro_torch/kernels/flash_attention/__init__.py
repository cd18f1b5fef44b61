from . import ops, ref
from .ops import KERNEL_LAUNCHES, flash_attention, reset_kernel_launches

__all__ = ["ops", "ref", "KERNEL_LAUNCHES", "flash_attention", "reset_kernel_launches"]
