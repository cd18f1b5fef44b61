"""Build and bind the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The CUDA source replaces the Pallas TPU kernel ``flash_attention_kernel`` of
``repro.kernels.flash_attention.kernel``; its header says what bounds it on
the card and what the design does about it.  The source is built and loaded
by :mod:`repro_torch.kernels._build` at the first launch; nothing happens at
import time.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import CudaLibrary

__all__ = ["HEAD_DIMS", "LIBRARY", "flash_attention_call"]

#: head dims the source instantiates
HEAD_DIMS = (16, 32, 64, 96, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_launch.argtypes = [
        c_int, c_int, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, c_int,
        ctypes.c_float, ptr,
    ]
    lib.flash_attention_fwd_launch.restype = c_int


LIBRARY = CudaLibrary(
    "flash_attention", Path(__file__).resolve().parent / "csrc" / "flash_attention.cu", _bind,
    error_fn="flash_attention_error_string",
)


def flash_attention_call(
    q: torch.Tensor,  # (BH, Sq, d)  BH = batch*kv_heads*groups
    k: torch.Tensor,  # (BK, Sk, d)  BK = batch*kv_heads
    v: torch.Tensor,
    *,
    groups: int,
    causal: bool,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors -> (BH, Sq, d) in the q dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got one on {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q (BH, Sq, d) and k, v (BK, Sk, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, sq, d = q.shape
    bk, sk, dk = k.shape
    if groups < 1 or bk * groups != bh or dk != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} does not hold {groups} query rows "
            f"for each of the KV heads of k {tuple(k.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention has no instance for head dim {d}; it has {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"flash_attention takes q_offset >= 0, got {q_offset}")
    if bh > 65535 or min(sq, sk) < 1 or max(bh, sq, sk) * d >= 2**31:
        raise ValueError(f"flash_attention cannot launch q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, q {q.dtype} on {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k and v")
    out = torch.empty_like(q)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):  # the C side launches on the current device
        err = lib.flash_attention_fwd_launch(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, sk, groups, int(causal), q_offset, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIBRARY.check(err, "flash_attention")
    return out
