"""Public wrapper: the SSD scan on the card, or plainly on the CPU.

The transposes and broadcasts of the reference's ``ops.ssd_scan`` are part
of the contract: dt (B, S, H) is flattened to the kernel's (B*H, S), A and D
are broadcast to (B*H, 1), and B and C stay (B, S, N), shared by the heads
of a batch entry.  Grouped B and C (B, S, G, N) become the kernel's (B*G, S,
N) rows, each shared by its H/G heads: the heads of group g are the g-th
run of H/G, so they line up with the heads of x and only B and C are
copied.  x (B, S, H, P) goes on as it lies, and the output comes back as
the mixer's (B, S, H, P): the split instance (bf16, P 64, N 64 or 128, on
the card) reads x and writes y with the heads interleaved along each
sequence row, so neither is copied, and its output is contiguous; the
``fwd`` instance and the plain version flatten x to (B*H, S, P) for
themselves, as the reference's wrapper flattens it.  A CPU tensor goes to
the plain version in :mod:`.ref`, a CUDA tensor to the hand-written kernel
in :mod:`.kernel` (or the launch raises).  Neither has a backward: the
reference kernel has no VJP.  :func:`.kernel.ssd_scan_call` counts each
call of the CUDA kernel (the split instance's call is two launches).
"""

from __future__ import annotations

import torch

from .._autograd import forward_only
from .kernel import ssd_scan_call
from .ref import ssd_scan_ref

__all__ = ["flatten", "ssd_scan"]


def _scan(x, dt, A, B_, C_, D_, heads: int, chunk: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B_, C_, D_, heads=heads, chunk=chunk)
    return ssd_scan_call(x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
                         B_.contiguous(), C_.contiguous(), D_.float().contiguous(),
                         heads=heads, chunk=chunk)


def ssd_scan(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,)
    B_: torch.Tensor,  # (B, S, N), or (B, S, G, N) in G groups of heads
    C_: torch.Tensor,  # (B, S, N), or (B, S, G, N)
    D_: torch.Tensor,  # (H,)
    *,
    chunk: int = 256,
) -> torch.Tensor:
    b, s, h, _ = x.shape
    heads = h
    if B_.ndim == 4:
        g, n = B_.shape[2:]
        if h % g:
            raise ValueError(f"ssd_scan: {h} heads do not split into {g} groups")
        B_, C_ = (t.permute(0, 2, 1, 3).reshape(b * g, s, n) for t in (B_, C_))
        heads = h // g
    dtf, af, df = _flatten_heads(dt, A, D_)
    return forward_only("ssd_scan", _scan, x, dtf, af, B_, C_, df, heads, chunk)


def flatten(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D_: torch.Tensor):
    """x (B,S,H,P), dt (B,S,H), A and D (H,) -> the kernel's x (B*H,S,P),
    dt (B*H,S), A and D (B*H,1), as the reference's wrapper makes them."""
    b, s, h, p = x.shape
    return (x.permute(0, 2, 1, 3).reshape(b * h, s, p), *_flatten_heads(dt, A, D_))


def _flatten_heads(dt: torch.Tensor, A: torch.Tensor, D_: torch.Tensor):
    b, s, h = dt.shape
    return (dt.permute(0, 2, 1).reshape(b * h, s), A[None, :].expand(b, h).reshape(b * h, 1),
            D_[None, :].expand(b, h).reshape(b * h, 1))
