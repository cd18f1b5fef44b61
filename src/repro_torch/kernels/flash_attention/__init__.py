from . import ops, ref
from .ops import HEAD_DIM_LAUNCHES, INSTANCE_LAUNCHES, KERNEL_LAUNCHES, flash_attention, reset_kernel_launches

__all__ = ["ops", "ref", "HEAD_DIM_LAUNCHES", "INSTANCE_LAUNCHES", "KERNEL_LAUNCHES", "flash_attention",
           "reset_kernel_launches"]
