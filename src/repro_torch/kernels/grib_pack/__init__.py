from . import ops, ref
from .ops import (
    grib_pack,
    grib_unpack,
    pack_to_bytes,
    payload_dtype,
    unpack_from_bytes,
)

__all__ = [
    "ops",
    "ref",
    "grib_pack",
    "grib_unpack",
    "pack_to_bytes",
    "payload_dtype",
    "unpack_from_bytes",
]
