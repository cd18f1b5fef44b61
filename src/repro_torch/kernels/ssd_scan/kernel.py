"""Build and bind the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

The CUDA source replaces the Pallas TPU kernel ``ssd_scan_kernel`` of
``repro.kernels.ssd_scan.kernel``; its header says what bounds it on the
card and what the design does about it.  The source is built and loaded by
:mod:`repro_torch.kernels._build` at the first launch; nothing happens at
import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

__all__ = ["HEAD_DIMS", "STATE_DIMS", "MAX_CHUNK", "LIBRARY", "ssd_scan_call"]

#: head dims (P) the source instantiates: tests/test_kernels.py's 8, 16 and
#: 64, which is also mamba2-370m's and zamba2-7b's
HEAD_DIMS = (8, 16, 64)
#: state sizes (N) it takes: the test shapes' 4, 8 and 16 (16 is the reduced
#: configs'), zamba2-7b's 64 and mamba2-370m's 128
STATE_DIMS = (4, 8, 16, 64, 128)
#: the longest chunk: its cumsum and decays stay in shared memory
MAX_CHUNK = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd_launch.argtypes = [
        c_int, c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, ptr,
    ]
    lib.ssd_scan_fwd_launch.restype = c_int


LIBRARY = CudaLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu", _bind,
    error_fn="ssd_scan_error_string",
)


def ssd_scan_call(
    x: torch.Tensor,   # (BH, S, P)
    dt: torch.Tensor,  # (BH, S) float32
    A: torch.Tensor,   # (BH, 1) float32
    B_: torch.Tensor,  # (BG, S, N)  BG = BH // heads (B/C shared across heads)
    C_: torch.Tensor,  # (BG, S, N)
    D_: torch.Tensor,  # (BH, 1) float32
    *,
    heads: int,
    chunk: int = 256,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors -> (BH, S, P) in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA tensors, got one on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan takes x, B and C in float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or dt.ndim != 2 or B_.ndim != 3 or B_.shape != C_.shape:
        raise ValueError(
            f"ssd_scan takes x (BH, S, P), dt (BH, S) and B, C (BG, S, N), got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B_.shape)}, {tuple(C_.shape)}"
        )
    bh, s, p = x.shape
    bg, sb, n = B_.shape
    if heads < 1 or bg * heads != bh or sb != s or tuple(dt.shape) != (bh, s):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)} and B {tuple(B_.shape)} do not "
            f"hold {heads} heads for each batch entry of B"
        )
    for name, t in (("A", A), ("D", D_)):
        if t.numel() != bh:
            raise ValueError(f"ssd_scan takes {name} of shape (BH, 1) = ({bh}, 1), got {tuple(t.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_scan has no instance for head dim {p}; it has {HEAD_DIMS}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd_scan has no instance for state size {n}; it has {STATE_DIMS}")
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of chunk {q}")
    if q > MAX_CHUNK:
        raise ValueError(f"ssd_scan takes chunks of at most {MAX_CHUNK} rows, got {q}")
    if max(bh * s * p, bg * s * n) >= 2**62:
        raise ValueError(f"ssd_scan cannot launch x {tuple(x.shape)}, B {tuple(B_.shape)}")
    for name, t, dtype in (("B", B_, x.dtype), ("C", C_, x.dtype), ("dt", dt, torch.float32),
                           ("A", A, torch.float32), ("D", D_, torch.float32)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype} on {t.device}, it must be {dtype} "
                             f"on {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, B_, C_, D_)):
        raise ValueError("ssd_scan takes contiguous x, dt, A, B, C and D")
    out = torch.empty_like(x)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.ssd_scan_fwd_launch(
            _DTYPES[x.dtype], p, x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), D_.data_ptr(), out.data_ptr(), bh, s, n, q, heads,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(err, "ssd_scan")
    return out
