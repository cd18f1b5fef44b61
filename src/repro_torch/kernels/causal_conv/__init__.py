from . import ops
from .ops import KERNEL_LAUNCHES, causal_conv1d, reset_kernel_launches

__all__ = ["ops", "KERNEL_LAUNCHES", "causal_conv1d", "reset_kernel_launches"]
