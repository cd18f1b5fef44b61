"""Public wrapper: GRIB simple packing on the card, or plainly on the CPU.

Dispatch follows the tensor: a CPU tensor goes to the plain version in
:mod:`.ref`, a CUDA tensor to the hand-written kernel in :mod:`.kernel`
(or the launch raises).  ``device=None`` means
:func:`repro_torch.device.default_device`, and the input is moved there
first.  :data:`KERNEL_LAUNCHES` counts launches of the CUDA kernels only.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ...device import resolve_device
from .kernel import grib_pack_call, grib_unpack_call
from .ref import field_stats, pack_ref, unpack_ref

__all__ = [
    "KERNEL_LAUNCHES",
    "grib_pack",
    "grib_unpack",
    "pack_to_bytes",
    "payload_dtype",
    "reset_kernel_launches",
    "unpack_from_bytes",
]

#: launches of each CUDA kernel (the plain CPU version is not counted)
KERNEL_LAUNCHES = {"grib_pack": 0, "grib_unpack": 0}
_launch_mu = threading.Lock()


def _count_launch(name: str) -> None:
    with _launch_mu:
        KERNEL_LAUNCHES[name] += 1


def reset_kernel_launches() -> None:
    with _launch_mu:
        for name in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[name] = 0


def payload_dtype(nbits: int) -> np.dtype:
    """The smallest unsigned container that holds an ``nbits`` code.

    GRIB's true bit-stream packs codes back to back; the wire container
    here is the next power-of-two integer width (uint8/uint16/uint32), so
    nbits in (8, 16, 32] trade no space while 24-bit codes ride in 4-byte
    containers — the effective-vs-wire telemetry reports container bytes.
    """
    if not isinstance(nbits, int) or not 1 <= nbits <= 32:
        raise ValueError(f"nbits must be an int in [1, 32], got {nbits!r}")
    if nbits <= 8:
        return np.dtype(np.uint8)
    if nbits <= 16:
        return np.dtype(np.uint16)
    return np.dtype(np.uint32)


def _on(a, device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()  # torch.as_tensor warns on read-only numpy buffers
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


def grib_pack(x, *, nbits: int = 16, device=None):
    """x: (F, H, W) float -> (codes (F, H, W) int32, ref (F,), scale (F,)),
    all on the resolved device."""
    x = _on(x, resolve_device(device), torch.float32)
    if x.ndim != 3:
        raise ValueError(f"grib_pack takes (F, H, W) fields, got shape {tuple(x.shape)}")
    ref, scale, inv_scale = field_stats(x, nbits)
    if x.device.type == "cpu":
        codes = pack_ref(x, ref, inv_scale, nbits)
    elif x.numel() == 0:  # no fields: nothing to launch
        codes = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    else:
        codes = grib_pack_call(x, ref, inv_scale, nbits=nbits)
        _count_launch("grib_pack")
    return codes, ref, scale


def grib_unpack(codes, ref, scale, *, device=None):
    """codes (F, H, W) int32, ref (F,), scale (F,) float32 -> (F, H, W) float32."""
    dev = resolve_device(device)
    codes = _on(codes, dev, torch.int32)
    ref = _on(ref, dev, torch.float32)
    scale = _on(scale, dev, torch.float32)
    if codes.ndim != 3:
        raise ValueError(f"grib_unpack takes (F, H, W) codes, got shape {tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return unpack_ref(codes, ref, scale)
    if codes.numel() == 0:
        return torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    out = grib_unpack_call(codes, ref, scale)
    _count_launch("grib_unpack")
    return out


def pack_to_bytes(x: np.ndarray, nbits: int = 16, *, device=None) -> tuple[bytes, dict]:
    """Host-side convenience: one field (H, W) -> GRIB-ish byte payload."""
    dtype = payload_dtype(nbits)
    codes, ref, scale = grib_pack(np.asarray(x)[None], nbits=nbits, device=device)
    arr = codes[0].cpu().numpy().astype(dtype)
    meta = {
        "ref": float(ref[0]),
        "scale": float(scale[0]),
        "shape": list(x.shape),
        "nbits": nbits,
        "dtype": dtype.name,
    }
    return arr.tobytes(), meta


def unpack_from_bytes(payload: bytes, meta: dict, *, device=None) -> np.ndarray:
    h, w = meta["shape"]
    dtype = (
        np.dtype(meta["dtype"])
        if "dtype" in meta
        else payload_dtype(meta.get("nbits", 16))
    )
    expected = h * w * dtype.itemsize
    if len(payload) != expected:
        raise ValueError(
            f"GRIB payload is {len(payload)} bytes but meta describes a "
            f"({h}, {w}) field of {dtype.name} codes ({expected} bytes) — "
            "payload and meta do not belong together"
        )
    codes = np.frombuffer(payload, dtype=dtype).reshape(h, w).astype(np.int32)
    out = grib_unpack(
        codes[None],
        np.asarray([meta["ref"]], dtype=np.float32),
        np.asarray([meta["scale"]], dtype=np.float32),
        device=device,
    )
    return out[0].cpu().numpy()
