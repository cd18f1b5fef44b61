from .analysis import HW
from .codec import CodecRoofline, codec_roofline, ridge_intensity

__all__ = [
    "HW",
    "CodecRoofline",
    "codec_roofline",
    "ridge_intensity",
]
