"""Plain PyTorch versions of the SSD scan.

``ssd_sequential_ref`` is the direct O(S) recurrence, the ground truth, as
in ``repro.kernels.ssd_scan.ref``.  ``ssd_scan_ref`` is the plain version of
the hand-written kernel: it takes the kernel's flattened shapes and computes
what the Pallas kernel body computes (``repro.kernels.ssd_scan.kernel``), not
what the oracle computes: every operand in float32, an inclusive cumsum of
``dt*a`` per chunk, the exponent masked to ``-inf`` before ``exp``, a carried
(P, N) float32 state, and ``y + D*x`` cast once to ``x``'s dtype.  B and C
are shared by the ``heads`` rows of one batch entry and broadcast, not
copied.

The cumsum adds the float32 products ``dt*a`` in float64 and rounds each
prefix once to float32, here and in the kernel, so its float32 values do
not depend on the order of the additions.  Every decay is
``exp(cum_i - cum_j)`` of prefixes that reach several hundred at a
256-row chunk, where one float32 ulp is 3e-5: two float32 scans in
different orders (a parallel scan on the card, a serial one in the
kernel) moved outputs by more than the kernel's 2e-4 tolerance at N = 64,
chunk 256 (3.6e-4 on an H100 in chip_smoke.py).  On the CPU, where the
tests hold this version against the Pallas kernel, torch's float32 cumsum
already accumulates in float64, so there the change moves no output.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_sequential_ref", "ssd_scan_ref"]


def ssd_sequential_ref(
    x: torch.Tensor,   # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,   # (H,)
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    D_: torch.Tensor,  # (H,)
) -> torch.Tensor:
    b, s, h, p = x.shape
    n = B_.shape[-1]
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    xf, dtf, bf, cf = x.float(), dt.float(), B_.float(), C_.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A)  # (B,H)
        hstate = decay[..., None, None] * hstate + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, cf[:, t]))
    y = torch.stack(ys, dim=1)  # (B,S,H,P)
    return (y + xf * D_[None, None, :, None]).to(x.dtype)


def ssd_scan_ref(
    x: torch.Tensor,   # (BH, S, P)
    dt: torch.Tensor,  # (BH, S)
    A: torch.Tensor,   # (BH, 1)
    B_: torch.Tensor,  # (BG, S, N)  BG = BH // heads
    C_: torch.Tensor,  # (BG, S, N)
    D_: torch.Tensor,  # (BH, 1)
    *,
    heads: int,
    chunk: int,
) -> torch.Tensor:
    bh, s, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of chunk {q}")
    bg = bh // heads
    xf = x.float().reshape(bg, heads, s, p)
    dtf = dt.float().reshape(bg, heads, s)
    a = A.float().reshape(bg, heads, 1)
    dsk = D_.float().reshape(bg, heads, 1, 1)
    bb_all = B_.float()[:, None]  # (BG, 1, S, N): one row of B per batch entry
    cc_all = C_.float()[:, None]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bg, heads, p, n), dtype=torch.float32, device=x.device)
    out = []
    for c0 in range(0, s, q):
        xc, dtc = xf[:, :, c0:c0 + q], dtf[:, :, c0:c0 + q]
        bb, cc = bb_all[:, :, c0:c0 + q], cc_all[:, :, c0:c0 + q]
        cum = torch.cumsum((dtc * a).double(), dim=-1).float()  # (BG,H,Q) inclusive
        total = cum[..., -1:]
        expnt = torch.where(causal, cum[..., :, None] - cum[..., None, :], float("-inf"))
        cb = torch.matmul(cc, bb.transpose(-1, -2))  # (BG,1,Q,Q)
        scores = cb * torch.exp(expnt) * dtc[..., None, :]
        y = torch.matmul(scores, xc)  # (BG,H,Q,P)
        y = y + torch.exp(cum)[..., None] * torch.matmul(cc, state.transpose(-1, -2))
        w = torch.exp(total - cum) * dtc  # (BG,H,Q)
        state = torch.exp(total)[..., None] * state + torch.matmul(
            (xc * w[..., None]).transpose(-1, -2), bb)
        out.append((y + dsk * xc).to(x.dtype))
    return torch.cat(out, dim=2).reshape(bh, s, p)
