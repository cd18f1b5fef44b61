"""Build and bind the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The CUDA source replaces the Pallas TPU kernel ``flash_attention_kernel`` of
``repro.kernels.flash_attention.kernel`` with two instances, picked from the
dtype and head dim alone (:func:`instance_for`): ``"wgmma"``, bf16 on the
tensor cores fed by TMA, at the head dims of the repo's models (64, 96, 112
and 128, and the published Zamba2's 224, with tiles of its own), and
``"cuda_cores"``, float32 arithmetic on the CUDA cores, for everything else
(float32 at every head dim, bf16 at 16 and 32).
The source's header says what bounds each on the card and what its design
does about it.  The source and ``kernels/csrc/hopper.cuh`` are built and
loaded by :mod:`repro_torch.kernels._build` at the first launch; nothing
happens at import time.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .._build import CudaLibrary

__all__ = ["HEAD_DIMS", "INSTANCES", "LIBRARY", "WGMMA_HEAD_DIMS", "WGMMA_KEY_BLOCK", "flash_attention_call",
           "instance_for"]

#: head dims of the CUDA-core instance (float32 at every one)
HEAD_DIMS = (16, 32, 64, 96, 112, 128)
#: head dims of the bf16 wgmma instance; 224 only there
WGMMA_HEAD_DIMS = (64, 96, 112, 128, 224)
#: keys a K/V stage of the wgmma instance, by head dim (``Dims<D>::BKV``)
WGMMA_KEY_BLOCK = {d: 128 if d <= 128 else 64 for d in WGMMA_HEAD_DIMS}
INSTANCES = ("wgmma", "cuda_cores")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_for(dtype: torch.dtype, d: int) -> str:
    """The kernel instance that computes attention of this dtype and head dim."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS else "cuda_cores"


def _bind(lib: ctypes.CDLL) -> None:
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_launch.argtypes = [
        c_int, c_int, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, c_int,
        ctypes.c_float, ptr,
    ]
    lib.flash_attention_fwd_launch.restype = c_int
    lib.flash_attention_wgmma_launch.argtypes = [
        c_int, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_float, ptr,
    ]
    lib.flash_attention_wgmma_launch.restype = c_int


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
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the kernel's instance for (q.dtype, d) on CUDA tensors -> (BH, Sq, d)
    in the q dtype; the scores are scaled by ``scale``, 1/sqrt(d) unless given."""
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
    if d not in HEAD_DIMS and instance_for(q.dtype, d) != "wgmma":
        raise ValueError(f"flash_attention has no instance for head dim {d} in {q.dtype}; it has "
                         f"{HEAD_DIMS}, and in bf16 {WGMMA_HEAD_DIMS}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if not (math.isfinite(scale) and scale > 0):  # the kernel folds the scale into a row max
        raise ValueError(f"flash_attention takes a positive finite scale, got {scale}")
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):  # the C side launches on the current device
        if instance_for(q.dtype, d) == "wgmma":
            # TMA reads from 16-byte aligned addresses; a view may start elsewhere
            q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
            err = lib.flash_attention_wgmma_launch(
                d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, sq, sk, groups, int(causal), q_offset, scale, stream,
            )
        else:
            err = lib.flash_attention_fwd_launch(
                _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, sq, sk, groups, int(causal), q_offset, scale, stream,
            )
    LIBRARY.check(err, "flash_attention")
    return out
