from .analysis import HW, RooflineReport, model_flops_for, parse_collectives, roofline
from .codec import CodecRoofline, codec_roofline, ridge_intensity

__all__ = [
    "HW",
    "RooflineReport",
    "model_flops_for",
    "parse_collectives",
    "roofline",
    "CodecRoofline",
    "codec_roofline",
    "ridge_intensity",
]
