from . import ops, ref
from .ops import INSTANCE_LAUNCHES, KERNEL_LAUNCHES, flash_attention, reset_kernel_launches

__all__ = ["ops", "ref", "INSTANCE_LAUNCHES", "KERNEL_LAUNCHES", "flash_attention",
           "reset_kernel_launches"]
