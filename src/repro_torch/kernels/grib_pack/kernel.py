"""Build and bind the Hopper GRIB pack/unpack kernels (``csrc/grib_pack.cu``).

The CUDA source replaces the Pallas TPU kernels ``_pack_kernel`` and
``_unpack_kernel`` of ``repro.kernels.grib_pack.kernel``; its header says
what bounds them on the card (HBM bytes) and what the design does about it.

The source is built and loaded by :mod:`repro_torch.kernels._build` at the
first launch of either kernel; nothing happens at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

__all__ = ["LIBRARY", "grib_pack_call", "grib_unpack_call"]


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.grib_pack_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ctypes.c_float, c_int, ptr]
    lib.grib_pack_f32.restype = c_int
    lib.grib_unpack_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, c_int, ptr]
    lib.grib_unpack_f32.restype = c_int


LIBRARY = CudaLibrary(
    "grib_pack", Path(__file__).resolve().parent / "csrc" / "grib_pack.cu", _bind,
    error_fn="grib_error_string",
)


def _check_inputs(name: str, big: torch.Tensor, dtype: torch.dtype,
                  ref: torch.Tensor, other: torch.Tensor) -> None:
    if big.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got one on {big.device}")
    if big.dtype != dtype or big.ndim != 3 or not big.is_contiguous():
        raise ValueError(
            f"{name} takes a contiguous (F, H, W) {dtype} tensor, got "
            f"{tuple(big.shape)} {big.dtype}"
        )
    if big.numel() == 0:
        raise ValueError(f"{name} takes a non-empty batch, got {tuple(big.shape)}")
    f = big.shape[0]
    for t in (ref, other):
        if t.device != big.device or t.dtype != torch.float32 or t.shape != (f,) or not t.is_contiguous():
            raise ValueError(
                f"{name} takes per-field float32 ({f},) scalars on {big.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _vectorisable(field_size: int, *tensors: torch.Tensor) -> int:
    return int(field_size % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def grib_pack_call(x: torch.Tensor, ref: torch.Tensor, inv_scale: torch.Tensor,
                   *, nbits: int) -> torch.Tensor:
    """Launch the pack kernel: x (F, H, W) float32 on CUDA -> codes (F, H, W) int32."""
    _check_inputs("grib_pack", x, torch.float32, ref, inv_scale)
    codes = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    f, h, w = x.shape
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.grib_pack_f32(
            x.data_ptr(), ref.data_ptr(), inv_scale.data_ptr(), codes.data_ptr(),
            f, h * w, float((1 << nbits) - 1), _vectorisable(h * w, x, codes),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(err, "grib_pack")
    return codes


def grib_unpack_call(codes: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the unpack kernel: codes (F, H, W) int32 on CUDA -> (F, H, W) float32."""
    _check_inputs("grib_unpack", codes, torch.int32, ref, scale)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    f, h, w = codes.shape
    lib = LIBRARY.load()
    with torch.cuda.device(codes.device):
        err = lib.grib_unpack_f32(
            codes.data_ptr(), ref.data_ptr(), scale.data_ptr(), out.data_ptr(),
            f, h * w, _vectorisable(h * w, codes, out),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    LIBRARY.check(err, "grib_unpack")
    return out
