from . import ops, ref
from .ops import (
    KERNEL_LAUNCHES,
    grib_pack,
    grib_unpack,
    pack_to_bytes,
    payload_dtype,
    reset_kernel_launches,
    unpack_from_bytes,
)

__all__ = [
    "ops",
    "ref",
    "KERNEL_LAUNCHES",
    "grib_pack",
    "grib_unpack",
    "pack_to_bytes",
    "payload_dtype",
    "reset_kernel_launches",
    "unpack_from_bytes",
]
