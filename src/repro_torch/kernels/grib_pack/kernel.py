"""Build and bind the Hopper GRIB pack/unpack kernels (``csrc/grib_pack.cu``).

The CUDA source replaces the Pallas TPU kernels ``_pack_kernel`` and
``_unpack_kernel`` of ``repro.kernels.grib_pack.kernel``; its header says
what bounds them on the card (HBM bytes) and what the design does about it.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at the first launch of either kernel, and loaded with
``ctypes``.  The library lands in ``src/repro_torch/build/`` under a name
keyed by a hash of the source and the flags, so an edit rebuilds.  Nothing
happens at import time: the CPU tests import this module on machines that
have no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["build", "grib_pack_call", "grib_unpack_call", "library_path"]

_SRC = Path(__file__).resolve().parent / "csrc" / "grib_pack.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None
_lib_mu = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libgrib_pack_{digest[:16]}.so"


def build() -> Path:
    """Compile the source unless a library of the same hash exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError(
            f"cannot build the grib_pack CUDA kernels: {cmd[0]} not found "
            "(set CUDA_HOME to the CUDA toolkit)"
        ) from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {_SRC.name} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_mu:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.grib_pack_f32.argtypes = [
                ptr, ptr, ptr, ptr, i64, i64, ctypes.c_float, c_int, ptr,
            ]
            lib.grib_pack_f32.restype = c_int
            lib.grib_unpack_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i64, c_int, ptr]
            lib.grib_unpack_f32.restype = c_int
            lib.grib_error_string.argtypes = [c_int]
            lib.grib_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        msg = lib.grib_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


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
    lib = _load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.grib_pack_f32(
            x.data_ptr(), ref.data_ptr(), inv_scale.data_ptr(), codes.data_ptr(),
            f, h * w, float((1 << nbits) - 1), _vectorisable(h * w, x, codes),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(lib, err, "grib_pack")
    return codes


def grib_unpack_call(codes: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the unpack kernel: codes (F, H, W) int32 on CUDA -> (F, H, W) float32."""
    _check_inputs("grib_unpack", codes, torch.int32, ref, scale)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    f, h, w = codes.shape
    lib = _load()
    with torch.cuda.device(codes.device):
        err = lib.grib_unpack_f32(
            codes.data_ptr(), ref.data_ptr(), scale.data_ptr(), out.data_ptr(),
            f, h * w, _vectorisable(h * w, codes, out),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    _check(lib, err, "grib_unpack")
    return out
