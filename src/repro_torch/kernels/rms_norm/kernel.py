"""Build and bind the one-pass RMSNorm, with its optional gate (``csrc/rms_norm.cu``).

The CUDA source replaces no TPU kernel: the reference normalises with jnp
(``repro.models.ops.rms_norm``).  It computes ``rms_norm(x)``, or
``rms_norm(x * silu(z))``, over each of G groups of W channels of a row, in
one pass over HBM, with the plain version's rounding points; its header says
what bounds it on the card and what the design does about it.  The source is
built and loaded by :mod:`repro_torch.kernels._build` at the first launch;
nothing happens at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

__all__ = ["LIBRARY", "WIDTH_MULTIPLE", "check_shapes", "rms_norm_call"]

#: a group's width W must be a multiple of this: 16 bytes of bf16, so every
#: group starts on a 16-byte vector (every width of the repo's models is)
WIDTH_MULTIPLE = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rms_norm_launch.argtypes = [c_int, ptr, ptr, ptr, ptr, i64, c_int, i64, ctypes.c_float, ptr]
    lib.rms_norm_launch.restype = c_int


# ptxas -v: the kernels' registers and spills in the build log
LIBRARY = CudaLibrary(
    "rms_norm", Path(__file__).resolve().parent / "csrc" / "rms_norm.cu", _bind,
    error_fn="rms_norm_error_string", extra_flags=("-Xptxas", "-v"),
)


def check_shapes(x: torch.Tensor, scale: torch.Tensor, z: torch.Tensor | None,
                 groups: int) -> int:
    """Raise on shapes the kernel does not take, on any device; the group width W."""
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"rms_norm takes a non-empty (..., G * W) x, got {tuple(x.shape)}")
    width = x.shape[-1]
    if groups < 1 or width % groups:
        raise ValueError(f"rms_norm cannot split {width} channels into {groups} groups")
    w = width // groups
    if w % WIDTH_MULTIPLE:
        raise ValueError(f"rms_norm takes a group width that is a multiple of {WIDTH_MULTIPLE}, "
                         f"got {w}")
    if tuple(scale.shape) != (width,):
        raise ValueError(f"rms_norm takes a ({width},) scale, got {tuple(scale.shape)}")
    if z is not None and z.shape != x.shape:
        raise ValueError(f"rms_norm takes a gate of x's shape {tuple(x.shape)}, got "
                         f"{tuple(z.shape)}")
    return w


def _check(x: torch.Tensor, scale: torch.Tensor, z: torch.Tensor | None, groups: int) -> int:
    """Raise on inputs the kernel does not take; the group width W."""
    w = check_shapes(x, scale, z, groups)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm takes CUDA tensors, got one on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm takes float32 or bfloat16, got {x.dtype}")
    named = (("x", x), ("scale", scale)) + ((("z", z),) if z is not None else ())
    for name, t in named:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"rms_norm: {name} is {t.dtype} on {t.device}, x is {x.dtype} on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rms_norm takes contiguous, 16-byte aligned tensors; {name} is not")
    return w


def rms_norm_call(x: torch.Tensor, scale: torch.Tensor, eps: float, z: torch.Tensor | None = None,
                  groups: int = 1) -> torch.Tensor:
    """Launch the kernel: x (..., G * W), scale (G * W,) and the gate z (x's
    shape, or None) of x's type on CUDA -> each group of W channels of
    ``x * silu(z)`` (or of x) normalised and scaled, x's shape, contiguous."""
    w = _check(x, scale, z, groups)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.rms_norm_launch(
            _DTYPES[x.dtype], x.data_ptr(), None if z is None else z.data_ptr(), scale.data_ptr(),
            out.data_ptr(), rows, groups, w, eps, torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(err, "rms_norm")
    return out

