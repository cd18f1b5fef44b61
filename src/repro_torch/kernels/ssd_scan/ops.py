"""Public wrapper: the SSD scan on the card, or plainly on the CPU.

The transposes and broadcasts of the reference's ``ops.ssd_scan`` are part
of the contract: x (B, S, H, P) and dt (B, S, H) are flattened to the
kernel's (B*H, S, P) and (B*H, S), A and D are broadcast to (B*H, 1), and B
and C stay (B, S, N), shared by the heads of a batch entry.  Grouped B and C
(B, S, G, N) become the kernel's (B*G, S, N) rows, each shared by its H/G
heads: the heads of group g are the g-th run of H/G, so x's flattening
already lines them up and only B and C are copied.  A CPU tensor
goes to the plain version in :mod:`.ref`, a CUDA tensor to the hand-written
kernel in :mod:`.kernel` (or the launch raises).  Neither has a backward:
the reference kernel has no VJP.  Each call of the CUDA kernel (the split
instance's call is two launches) is counted in :mod:`..launches` under
``ssd_scan``, and by the ``instance`` that ran it.
"""

from __future__ import annotations

import torch

from .. import launches
from .._autograd import forward_only
from .kernel import instance_for, ssd_scan_call
from .ref import ssd_scan_ref

__all__ = ["flatten", "ssd_scan"]


def _scan(x, dt, A, B_, C_, D_, heads: int, chunk: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B_, C_, D_, heads=heads, chunk=chunk)
    out = ssd_scan_call(x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
                        B_.contiguous(), C_.contiguous(), D_.float().contiguous(),
                        heads=heads, chunk=chunk)
    launches.count("ssd_scan", instance=instance_for(x.dtype, x.shape[-1], B_.shape[-1]))
    return out


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
    b, s, h, p = x.shape
    heads = h
    if B_.ndim == 4:
        g, n = B_.shape[2:]
        if h % g:
            raise ValueError(f"ssd_scan: {h} heads do not split into {g} groups")
        B_, C_ = (t.permute(0, 2, 1, 3).reshape(b * g, s, n) for t in (B_, C_))
        heads = h // g
    xf, dtf, af, df = flatten(x, dt, A, D_)
    out = forward_only("ssd_scan", _scan, xf, dtf, af, B_, C_, df, heads, chunk)
    return out.reshape(b, h, s, p).permute(0, 2, 1, 3)


def flatten(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, D_: torch.Tensor):
    """x (B,S,H,P), dt (B,S,H), A and D (H,) -> the kernel's x (B*H,S,P),
    dt (B*H,S), A and D (B*H,1), as the reference's wrapper makes them."""
    b, s, h, p = x.shape
    return (x.permute(0, 2, 1, 3).reshape(b * h, s, p), dt.permute(0, 2, 1).reshape(b * h, s),
            A[None, :].expand(b, h).reshape(b * h, 1), D_[None, :].expand(b, h).reshape(b * h, 1))
