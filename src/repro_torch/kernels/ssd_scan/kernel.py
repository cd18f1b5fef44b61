"""Build and bind the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

The CUDA source replaces the Pallas TPU kernel ``ssd_scan_kernel`` of
``repro.kernels.ssd_scan.kernel`` with two instances, picked from the dtype,
head dim and state size alone (:func:`instance_for`): ``"split"``, bf16 on
the tensor cores in two launches, at the heads of the repo's models, and
``"fwd"``, float32 arithmetic on the CUDA cores, for
everything else.  The source's header says what bounds each on the card and
what its design does about it.  The source and ``kernels/csrc/hopper.cuh``
are built and loaded by :mod:`repro_torch.kernels._build` at the first
launch; nothing happens at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import launches
from .._build import CudaLibrary

__all__ = ["HEAD_DIMS", "INSTANCES", "LIBRARY", "MAX_CHUNK", "SPLIT_HEAD_DIM", "SPLIT_STATE_DIMS",
           "STATE_DIMS", "SplitScan", "instance_for", "ssd_scan_call"]

#: head dims (P) the source instantiates: tests/test_kernels.py's 8, 16 and
#: 64, which is also mamba2-370m's and zamba2-7b's, and benchmarks/run.py's 32
HEAD_DIMS = (8, 16, 32, 64)
#: state sizes (N) it takes: the test shapes' 4, 8 and 16 (16 is the reduced
#: configs'), zamba2-7b's 64 and mamba2-370m's 128
STATE_DIMS = (4, 8, 16, 64, 128)
#: the head dim and state sizes of the split instance (in bf16)
SPLIT_HEAD_DIM = 64
SPLIT_STATE_DIMS = (64, 128)
#: the longest chunk: its cumsum and decays stay in shared memory
MAX_CHUNK = 2048
INSTANCES = ("split", "fwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_for(dtype: torch.dtype, p: int, n: int) -> str:
    """The kernel instance that scans x, B and C of this dtype, head dim and state size."""
    split = dtype == torch.bfloat16 and p == SPLIT_HEAD_DIM and n in SPLIT_STATE_DIMS
    return "split" if split else "fwd"


def _bind(lib: ctypes.CDLL) -> None:
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd_launch.argtypes = [
        c_int, c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, ptr,
    ]
    lib.ssd_chunk_state_launch.argtypes = [
        c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, ptr,
    ]
    lib.ssd_chunk_state_group.argtypes = [c_int]
    lib.ssd_chunk_state_smem.argtypes = [c_int]
    lib.ssd_chunk_state_blocks_per_sm.argtypes = [c_int]
    lib.ssd_chunk_scan_launch.argtypes = [
        c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int, c_int, c_int, ptr,
    ]
    lib.ssd_chunk_scan_group.argtypes = [c_int]
    lib.ssd_chunk_scan_smem.argtypes = [c_int]
    for fn in (lib.ssd_scan_fwd_launch, lib.ssd_chunk_state_launch, lib.ssd_chunk_state_group,
               lib.ssd_chunk_state_smem, lib.ssd_chunk_state_blocks_per_sm, lib.ssd_chunk_scan_launch,
               lib.ssd_chunk_scan_group, lib.ssd_chunk_scan_smem):
        fn.restype = c_int


# ptxas -v: each kernel's registers, spills and static shared memory in the build log
LIBRARY = CudaLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu", _bind,
    error_fn="ssd_scan_error_string", extra_flags=("-Xptxas", "-v"),
)


def _check(x, dt, A, B_, C_, D_, heads: int, chunk: int) -> tuple[int, int, int, int, int]:
    """Raise on inputs no instance takes; (BH, S, P, N, Q)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CUDA tensors, got one on {x.device}")
    return check_shapes(x, dt, A, B_, C_, D_, heads, chunk)


def check_shapes(x, dt, A, B_, C_, D_, heads: int, chunk: int) -> tuple[int, int, int, int, int]:
    """The checks of :func:`_check` that need no card: raise on inputs no
    instance takes; (BH, S, P, N, Q).  x is (BH, S, P), or (B, S, H, P) with
    BH = B H."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan takes x, B and C in float32 or bfloat16, got {x.dtype}")
    if x.ndim not in (3, 4) or dt.ndim != 2 or B_.ndim != 3 or B_.shape != C_.shape:
        raise ValueError(
            f"ssd_scan takes x (BH, S, P) or (B, S, H, P), dt (BH, S) and B, C (BG, S, N), got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B_.shape)}, {tuple(C_.shape)}"
        )
    bh, s, p = heads_per_row(x) * x.shape[0], x.shape[1], x.shape[-1]
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
    if max(bh * s * p, bg * s * n, bh * s * n * p // q) >= 2**62:
        raise ValueError(f"ssd_scan cannot launch x {tuple(x.shape)}, B {tuple(B_.shape)}")
    for name, t, dtype in (("B", B_, x.dtype), ("C", C_, x.dtype), ("dt", dt, torch.float32),
                           ("A", A, torch.float32), ("D", D_, torch.float32)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype} on {t.device}, it must be {dtype} "
                             f"on {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, B_, C_, D_)):
        raise ValueError("ssd_scan takes contiguous x, dt, A, B, C and D")
    return bh, s, p, n, q


def heads_per_row(x: torch.Tensor) -> int:
    """The heads interleaved along each sequence row of x: H of a (B, S, H,
    P) x, 1 of a flat (BH, S, P) one."""
    return x.shape[2] if x.ndim == 4 else 1


class SplitScan:
    """The split instance's two launches over one set of inputs, with their
    scratch: :meth:`chunk_state` fills :attr:`cum` (BH, S) and :attr:`h` (BH,
    chunks, N, P), the state entering each chunk, both float32, and
    :meth:`chunk_scan` fills :attr:`out` bf16 in x's layout: (BH, S, P), or
    the mixer's (B, S, H, P), which the kernels read and write where it lies
    (head bh's row s at [bh // H, s, bh % H]).  Each launches one
    kernel on the current stream and raises if it fails; :meth:`run` launches
    the two in order.  :attr:`sync` holds the first launch's ticket and the
    chunks' flags, zeroed by each launch on its stream: an instance runs on
    one stream at a time.  The inputs are checked as :func:`ssd_scan_call`
    checks them, and must be the split instance's."""

    def __init__(self, x, dt, A, B_, C_, D_, *, heads: int, chunk: int = 256):
        bh, s, p, n, q = _check(x, dt, A, B_, C_, D_, heads, chunk)
        if instance_for(x.dtype, p, n) != "split":
            raise ValueError(f"the split instance takes bf16 x, B and C at head dim "
                             f"{SPLIT_HEAD_DIM} and state sizes {SPLIT_STATE_DIMS}, got {x.dtype} "
                             f"at {p} and {n}")
        # a TMA map needs a 16-byte aligned base (its strides, rows of 64 or
        # 128 bf16, are multiples of 16 bytes); a view may start elsewhere
        self.x, self.B, self.C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, B_, C_))
        self.dt, self.A, self.D = dt, A, D_
        self.bh, self.s, self.n, self.q, self.heads = bh, s, n, q, heads
        self.hrow = heads_per_row(x)
        nc = s // q
        self.cum = torch.empty((bh, s), dtype=torch.float32, device=x.device)
        self.h = torch.empty((bh, nc, n, p), dtype=torch.float32, device=x.device)
        self.sync = torch.empty(1 + bh * nc, dtype=torch.int32, device=x.device)
        self.out = torch.empty_like(x)
        self._lib = LIBRARY.load()

    def _launch(self, what: str, fn, *args) -> None:
        stream = torch.cuda.current_stream(self.x.device).cuda_stream
        with torch.cuda.device(self.x.device):  # the C side launches on the current device
            err = fn(self.n, *args, stream)
        LIBRARY.check(err, what)

    def chunk_state(self, states: torch.Tensor | None = None) -> None:
        """cum and h.  With ``states``, a float32 (BH, chunks - 1, N, P) tensor,
        the same launch also writes each chunk's own state S_c there: a check
        output, not a second path."""
        if states is not None and (states.shape != (self.bh, self.s // self.q - 1, self.n, SPLIT_HEAD_DIM)
                                   or states.dtype != torch.float32 or states.device != self.x.device
                                   or not states.is_contiguous()):
            raise ValueError(f"chunk_state writes states of shape ({self.bh}, {self.s // self.q - 1}, "
                             f"{self.n}, {SPLIT_HEAD_DIM}) float32 on {self.x.device}, got "
                             f"{tuple(states.shape)} {states.dtype} on {states.device}")
        self._launch("ssd_chunk_state", self._lib.ssd_chunk_state_launch, self.x.data_ptr(),
                     self.dt.data_ptr(), self.A.data_ptr(), self.B.data_ptr(), self.cum.data_ptr(),
                     self.h.data_ptr(), None if states is None else states.data_ptr(),
                     self.sync.data_ptr(), self.bh, self.s, self.q, self.heads, self.hrow)

    def chunk_scan(self) -> None:
        self._launch("ssd_chunk_scan", self._lib.ssd_chunk_scan_launch, self.x.data_ptr(),
                     self.dt.data_ptr(), self.cum.data_ptr(), self.h.data_ptr(), self.B.data_ptr(),
                     self.C.data_ptr(), self.D.data_ptr(), self.out.data_ptr(), self.bh, self.s,
                     self.q, self.heads, self.hrow)

    def run(self) -> torch.Tensor:
        self.chunk_state()
        self.chunk_scan()
        return self.out


def ssd_scan_call(
    x: torch.Tensor,   # (BH, S, P), or (B, S, H, P) with BH = B H
    dt: torch.Tensor,  # (BH, S) float32
    A: torch.Tensor,   # (BH, 1) float32
    B_: torch.Tensor,  # (BG, S, N)  BG = BH // heads (B/C shared across heads)
    C_: torch.Tensor,  # (BG, S, N)
    D_: torch.Tensor,  # (BH, 1) float32
    *,
    heads: int,
    chunk: int = 256,
) -> torch.Tensor:
    """Launch the kernel's instance for (x.dtype, P, N) on CUDA tensors ->
    x's dtype and layout.  The split instance reads a (B, S, H, P) x where it
    lies; ssd_scan_fwd reads the flat layout, so such an x is flattened for
    it.  Each call is counted in :mod:`..launches` under ``ssd_scan``, by the
    ``instance`` that ran it and by the ``layout`` that instance read x in:
    ``"bshp"`` or ``"flat"``."""
    bh, s, p, n, q = _check(x, dt, A, B_, C_, D_, heads, chunk)
    instance = instance_for(x.dtype, p, n)
    if instance == "split":
        out = SplitScan(x, dt, A, B_, C_, D_, heads=heads, chunk=chunk).run()
    elif x.ndim == 3:
        out = _fwd(x, dt, A, B_, C_, D_, heads, n, q)
    else:
        flat = _fwd(x.permute(0, 2, 1, 3).reshape(bh, s, p), dt, A, B_, C_, D_, heads, n, q)
        out = flat.reshape(x.shape[0], x.shape[2], s, p).permute(0, 2, 1, 3).contiguous()
    launches.count("ssd_scan", instance=instance,
                   layout="bshp" if instance == "split" and x.ndim == 4 else "flat")
    return out


def _fwd(x, dt, A, B_, C_, D_, heads: int, n: int, q: int) -> torch.Tensor:
    """ssd_scan_fwd on a flat (BH, S, P) x."""
    bh, s, p = x.shape
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
