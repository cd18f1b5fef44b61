from . import ops, ref
from .ops import ssd_scan

__all__ = ["ops", "ref", "ssd_scan"]
