"""Roofline placement of the GRIB pack/unpack kernels.

The codec kernels are streaming quantisers: per element, ``grib_pack`` does
a subtract, a multiply, a round and a clamp (~4 flops) against 4 B read +
``nbits/8`` B written, and ``grib_unpack`` a multiply-add (~2 flops) against
``nbits/8`` B read + 4 B written.  Their arithmetic intensity is therefore
well under 1 flop/byte, orders of magnitude below the HBM ridge point
(``peak_flops / hbm_bw`` = 989e12 / 3.35e12 ≈ 295 flop/B on the H100 of
:mod:`repro_torch.roofline.analysis`) — the codec is memory-bound, and fusing
it onto the archive path costs one extra HBM pass, never compute.

The byte count models codes at their CONTAINER width (uint8/uint16/uint32),
the reference's design; the port's kernels move int32 codes (4 B a code),
and ``chip_smoke.py`` bounds them by those bytes.

These analytic probes let the benchmarks report where a codec configuration
sits on the roofline without a compiled artifact: the kernels are too simple
for HLO cost analysis to say anything the closed form doesn't.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..kernels.grib_pack.ops import payload_dtype
from .analysis import HW

__all__ = ["CodecRoofline", "codec_roofline", "ridge_intensity"]

# per-element flop model (see module docstring)
_PACK_FLOPS_PER_ELEM = 4.0    # subtract, scale, round, clamp
_UNPACK_FLOPS_PER_ELEM = 2.0  # multiply-add


def ridge_intensity(hw: dict | None = None) -> float:
    """The HBM ridge point in flop/byte — kernels below it are memory-bound."""
    hw = HW if hw is None else hw
    return hw["peak_flops"] / hw["hbm_bw"]


@dataclass
class CodecRoofline:
    kind: str                 # "pack" | "unpack"
    nbits: int
    n_elems: int
    flops: float
    hbm_bytes: float          # raw bytes + code bytes + ref/scale traffic
    intensity: float          # flop/byte
    ridge: float              # HBM ridge point of the HW model
    bound: str                # "memory" | "compute"
    compute_s: float          # analytic lower-bound times on the HW model
    memory_s: float

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def codec_roofline(
    kind: str,
    shape: tuple[int, ...],
    *,
    nbits: int = 16,
    hw: dict | None = None,
) -> CodecRoofline:
    """Analytic roofline terms for one codec launch over fields of *shape*.

    ``shape`` is ``(F, H, W)`` (or any shape; elements are what matter).
    Byte traffic counts the float32 side once and the packed side once at
    the CONTAINER width (24-bit codes ride uint32 lanes, same honest
    convention as the wire format).
    """
    if kind not in ("pack", "unpack"):
        raise ValueError(f"kind must be 'pack' or 'unpack', got {kind!r}")
    hw = HW if hw is None else hw
    n = int(np.prod(shape)) if shape else 0
    code_itemsize = payload_dtype(nbits).itemsize
    if kind == "pack":
        flops = _PACK_FLOPS_PER_ELEM * n
        # read f32 twice (min/max reduction pass + quantise pass), write codes
        hbm = n * (2 * 4 + code_itemsize)
    else:
        flops = _UNPACK_FLOPS_PER_ELEM * n
        hbm = n * (code_itemsize + 4)
    intensity = flops / hbm if hbm else 0.0
    ridge = ridge_intensity(hw)
    compute_s = flops / hw["peak_flops"]
    memory_s = hbm / hw["hbm_bw"]
    return CodecRoofline(
        kind=kind, nbits=nbits, n_elems=n,
        flops=flops, hbm_bytes=float(hbm),
        intensity=intensity, ridge=ridge,
        bound="memory" if intensity < ridge else "compute",
        compute_s=compute_s, memory_s=memory_s,
    )
