from . import ops, ref
from .ops import KERNEL_LAUNCHES, reset_kernel_launches, ssd_scan

__all__ = ["ops", "ref", "KERNEL_LAUNCHES", "reset_kernel_launches", "ssd_scan"]
