from . import ops, ref
from .ops import INSTANCE_LAUNCHES, KERNEL_LAUNCHES, reset_kernel_launches, ssd_scan

__all__ = ["ops", "ref", "INSTANCE_LAUNCHES", "KERNEL_LAUNCHES", "reset_kernel_launches", "ssd_scan"]
