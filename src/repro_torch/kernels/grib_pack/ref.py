"""Plain PyTorch version of GRIB simple packing.

The CPU path of :mod:`.ops` runs these; on the card they are only the
comparison for the CUDA kernels.  Every step rounds in float32 exactly where
the reference's jitted ``repro.kernels.grib_pack.grib_pack`` rounds, so
``ref``/``scale``/``inv_scale`` are bit-equal to it, and given the same
stats the codes equal its ``pack_ref``.
"""

from __future__ import annotations

import torch

__all__ = ["field_stats", "pack_ref", "unpack_ref"]

_INT32_MAX = torch.iinfo(torch.int32).max


def _maxcode(nbits: int) -> int:
    maxcode = (1 << nbits) - 1
    if maxcode > _INT32_MAX:
        # the reference's int32 codes cannot hold 2^32 - 1: its jitted
        # division overflows on the Python int, so nbits=32 fails there
        raise OverflowError(
            f"maxcode {maxcode} of nbits={nbits} overflows the int32 codes"
        )
    return maxcode


def field_stats(x: torch.Tensor, nbits: int = 16):
    """Per-field (ref, scale, inv_scale). x: (F, H, W) float32."""
    maxcode = _maxcode(nbits)
    lo = x.amin(dim=(1, 2))
    hi = x.amax(dim=(1, 2))
    # The reference's wire path runs field_stats under jit, where XLA folds
    # `/ maxcode` into `* fl32(1 / fl32(maxcode))`; the port rounds the same
    # way, so headers match byte for byte.  (Un-jitted, the reference divides
    # truly and can land one ulp away, e.g. span 3 at nbits=8.)  Constants are
    # float32 tensors on x's device, so CUDA divides them truly too.
    eps = torch.tensor(1e-30, dtype=torch.float32, device=x.device)
    maxcode_t = torch.tensor(maxcode, dtype=torch.float32, device=x.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=x.device)
    scale = torch.maximum(hi - lo, eps) * torch.div(one, maxcode_t)
    return lo, scale, torch.div(one, scale)


def pack_ref(x: torch.Tensor, ref: torch.Tensor, inv_scale: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    maxcode = _maxcode(nbits)
    code = torch.round((x.to(torch.float32) - ref[:, None, None]) * inv_scale[:, None, None])
    code = torch.clamp(code, 0, maxcode)
    # at nbits=31 the float32 clip bound is 2^31; XLA and CUDA saturate it to
    # INT32_MAX, torch's CPU cast would wrap it to INT32_MIN
    return code.to(torch.int64).clamp_(max=maxcode).to(torch.int32)


def unpack_ref(codes: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale[:, None, None] + ref[:, None, None]
