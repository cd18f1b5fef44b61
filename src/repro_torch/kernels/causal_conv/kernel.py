"""Build and bind the mixer's channel-last causal convolution (``csrc/causal_conv.cu``).

The CUDA source replaces no TPU kernel: the reference convolves with
``jax.lax.conv_general_dilated`` (``repro.models.ssm.causal_conv1d``).  It
computes ``silu(causal_depthwise_conv(x, w) + bias)`` on the (B, S, C) layout
in one pass over HBM, bit for bit as the plain version does; its header says
what bounds it on the card and what the design does about it.  The source is
built and loaded by :mod:`repro_torch.kernels._build` at the first launch;
nothing happens at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

__all__ = ["CHANNEL_MULTIPLE", "LIBRARY", "TAPS", "causal_conv1d_call"]

#: the channel count must be a multiple of this: the source's kVec, the
#: channels one thread owns (every width of the repo's models is)
CHANNEL_MULTIPLE = 4
#: the one tap count (d_conv) the source instantiates, every config's
TAPS = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.causal_conv1d_launch.argtypes = [c_int, c_int, ptr, ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.causal_conv1d_launch.restype = c_int


# ptxas -v: the kernels' registers and spills in the build log
LIBRARY = CudaLibrary(
    "causal_conv", Path(__file__).resolve().parent / "csrc" / "causal_conv.cu", _bind,
    error_fn="causal_conv_error_string", extra_flags=("-Xptxas", "-v"),
)


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on inputs the kernel does not take; (B, S, C, K)."""
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d takes CUDA tensors, got one on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"causal_conv1d takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"causal_conv1d takes a non-empty (B, S, C) x, got {tuple(x.shape)}")
    b, s, c = x.shape
    if c % CHANNEL_MULTIPLE or c == 0:
        raise ValueError(f"causal_conv1d takes a channel count that is a multiple of "
                         f"{CHANNEL_MULTIPLE}, got {c}")
    if w.shape != (TAPS, c):
        raise ValueError(f"causal_conv1d takes ({TAPS}, {c}) weights (K = {TAPS}), "
                         f"got {tuple(w.shape)}")
    if bias.shape != (c,):
        raise ValueError(f"causal_conv1d takes a ({c},) bias, got {tuple(bias.shape)}")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"causal_conv1d: {name} is {t.dtype} on {t.device}, x is {x.dtype} "
                             f"on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"causal_conv1d takes contiguous, 16-byte aligned tensors; {name} "
                             "is not")
    return b, s, c, w.shape[0]


def causal_conv1d_call(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (B, S, C), w (K, C), bias (C,) of x's type on CUDA ->
    silu(causal conv + bias) (B, S, C), contiguous."""
    b, s, c, k = _check(x, w, bias)
    out = torch.empty_like(x)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.causal_conv1d_launch(
            _DTYPES[x.dtype], k, x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, s, c, torch.cuda.current_stream(x.device).cuda_stream,
        )
    LIBRARY.check(err, "causal_conv1d")
    return out
