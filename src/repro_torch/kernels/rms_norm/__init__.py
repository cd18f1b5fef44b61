from . import ops
from .ops import KERNEL_LAUNCHES, PLAIN_ON_CARD, reset_kernel_launches, rms_norm

__all__ = ["ops", "KERNEL_LAUNCHES", "PLAIN_ON_CARD", "reset_kernel_launches", "rms_norm"]
