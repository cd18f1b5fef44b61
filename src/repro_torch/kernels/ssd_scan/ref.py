"""Plain PyTorch versions of the SSD scan.

``ssd_sequential_ref`` is the direct O(S) recurrence, the ground truth, as
in ``repro.kernels.ssd_scan.ref``.  ``ssd_scan_ref`` is the plain version of
the hand-written kernel: it takes the kernel's shapes (x flattened to (BH,
S, P), or the mixer's (B, S, H, P), which it flattens and gives back as it
came) and computes
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

``split_bf16=True`` rounds each operand that the split instance derives in
float32 and feeds to the tensor cores as :data:`SPLIT_TERMS` bf16 values
(t0 = bf16(v), t1 = bf16(v - t0), ...) to their sum: the scores, ``w * x``
and the state entering each chunk.  It is the counterpart of the attention
kernel's ``round_p``.  Three terms keep about 2^-26 of each operand, below
float32's own rounding; two (hi + lo, 2^-18) moved the held-out loss of
trained mamba2-370m in ``chip_smoke.py`` by 1.7e-3, past its 3e-4 gate.

The split instance computes the same scan in two launches, and each has a
plain version here with its operation order: :func:`ssd_chunk_state_pass_ref`
(the cumsum and the state entering each chunk) and :func:`ssd_chunk_scan_ref`
(every chunk's outputs, all chunks at once).  The first launch's two parts
have their own plain functions, which its check output is held against:
:func:`ssd_chunk_state_ref` (the cumsum and every chunk's own state
contribution, all chunks at once) and :func:`ssd_state_pass_ref` (the only
serial part: the state entering each chunk).  Their layouts are the
kernels': chunk states are (BH, chunks, N, P), the transpose of the carried
(P, N) state above.
"""

from __future__ import annotations

import torch

__all__ = ["SPLIT_TERMS", "split_bf16_round", "ssd_chunk_scan_ref", "ssd_chunk_state_pass_ref",
           "ssd_chunk_state_ref", "ssd_scan_ref", "ssd_sequential_ref", "ssd_state_pass_ref"]


#: bf16 terms the split instance feeds each float32 operand it derives as
SPLIT_TERMS = 3


def split_bf16_round(v: torch.Tensor, terms: int = SPLIT_TERMS) -> torch.Tensor:
    """float32 ``v`` as the tensor cores see it fed as ``terms`` bf16 values,
    t0 = bf16(v), t1 = bf16(v - t0), ... (each difference exact): their sum,
    within about 2^-(9 terms - 1) of ``v`` relative."""
    out, rest = torch.zeros_like(v), v
    for _ in range(terms):
        t = rest.bfloat16().float()
        out, rest = out + t, rest - t
    return out


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
    x: torch.Tensor,   # (BH, S, P), or (B, S, H, P) with BH = B H
    dt: torch.Tensor,  # (BH, S)
    A: torch.Tensor,   # (BH, 1)
    B_: torch.Tensor,  # (BG, S, N)  BG = BH // heads
    C_: torch.Tensor,  # (BG, S, N)
    D_: torch.Tensor,  # (BH, 1)
    *,
    heads: int,
    chunk: int,
    split_bf16: bool = False,
) -> torch.Tensor:
    if x.ndim == 4:
        b, s, h, p = x.shape
        out = ssd_scan_ref(x.permute(0, 2, 1, 3).reshape(b * h, s, p), dt, A, B_, C_, D_,
                           heads=heads, chunk=chunk, split_bf16=split_bf16)
        return out.reshape(b, h, s, p).permute(0, 2, 1, 3)
    rnd = split_bf16_round if split_bf16 else (lambda v: v)
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
        y = torch.matmul(rnd(scores), xc)  # (BG,H,Q,P)
        y = y + torch.exp(cum)[..., None] * torch.matmul(cc, rnd(state).transpose(-1, -2))
        w = torch.exp(total - cum) * dtc  # (BG,H,Q)
        state = torch.exp(total)[..., None] * state + torch.matmul(
            rnd(xc * w[..., None]).transpose(-1, -2), bb)
        out.append((y + dsk * xc).to(x.dtype))
    return torch.cat(out, dim=2).reshape(bh, s, p)


def ssd_chunk_state_ref(
    x: torch.Tensor,   # (BH, S, P)
    dt: torch.Tensor,  # (BH, S)
    A: torch.Tensor,   # (BH, 1)
    B_: torch.Tensor,  # (BG, S, N)
    *,
    heads: int,
    chunk: int,
    split_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first launch's first part: cum (BH, S) float32, each chunk's
    inclusive cumsum of ``dt*a`` (float64 sums, each prefix rounded once), and
    the state that each chunk but the last adds on its own, ``B^T (w * x)``
    with ``w = exp(total - cum) dt``, as (BH, chunks - 1, N, P) float32."""
    bh, s, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    nc = s // q
    bg = bh // heads
    dtc = dt.float().reshape(bh, nc, q)
    cum = torch.cumsum((dtc * A.float().reshape(bh, 1, 1)).double(), dim=-1).float()
    w = torch.exp(cum[..., -1:] - cum) * dtc  # (BH, nc, Q)
    wx = (split_bf16_round if split_bf16 else (lambda v: v))(
        x.float().reshape(bh, nc, q, p) * w[..., None])
    bb = B_.float().reshape(bg, 1, nc, q, n)
    states = torch.matmul(bb.transpose(-1, -2), wx.reshape(bg, heads, nc, q, p))  # (BG,H,nc,N,P)
    return cum.reshape(bh, s), states.reshape(bh, nc, n, p)[:, :-1]


def ssd_state_pass_ref(states: torch.Tensor, cum: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The first launch's second part: from the chunk states (BH, chunks - 1,
    N, P) and the cumsum (BH, S), the state entering each chunk, (BH, chunks,
    N, P) float32: h_0 = 0, h_{c+1} = exp(total_c) h_c + states_c, in order."""
    bh, s = cum.shape
    q = min(chunk, s)
    nc = s // q
    decay = torch.exp(cum[:, q - 1::q])  # (BH, nc): exp of each chunk's total
    h = torch.zeros((bh, *states.shape[2:]), dtype=torch.float32, device=states.device)
    out = [h]
    for c in range(nc - 1):
        h = decay[:, c, None, None] * h + states[:, c]
        out.append(h)
    return torch.stack(out, dim=1)


def ssd_chunk_state_pass_ref(
    x: torch.Tensor,   # (BH, S, P)
    dt: torch.Tensor,  # (BH, S)
    A: torch.Tensor,   # (BH, 1)
    B_: torch.Tensor,  # (BG, S, N)
    *,
    heads: int,
    chunk: int,
    split_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first launch: cum (BH, S) and the state entering each chunk, h
    (BH, chunks, N, P), both float32; :func:`ssd_chunk_state_ref`, then
    :func:`ssd_state_pass_ref` over its chunk states."""
    cum, states = ssd_chunk_state_ref(x, dt, A, B_, heads=heads, chunk=chunk, split_bf16=split_bf16)
    return cum, ssd_state_pass_ref(states, cum, chunk=chunk)


def ssd_chunk_scan_ref(
    x: torch.Tensor,    # (BH, S, P)
    dt: torch.Tensor,   # (BH, S)
    cum: torch.Tensor,  # (BH, S) float32, from ssd_chunk_state_pass_ref
    h: torch.Tensor,    # (BH, chunks, N, P) float32, from ssd_chunk_state_pass_ref
    C_: torch.Tensor,   # (BG, S, N)
    B_: torch.Tensor,   # (BG, S, N)
    D_: torch.Tensor,   # (BH, 1)
    *,
    heads: int,
    chunk: int,
    split_bf16: bool = False,
) -> torch.Tensor:
    """The second launch: every chunk's outputs, (BH, S, P) in x's dtype:
    ``(scores x + exp(cum) (C h^T)) + D x`` with ``scores = (C B^T)
    exp(cum_i - cum_j) dt_j`` on and below the diagonal, 0 above it (the
    exponent there is never taken)."""
    rnd = split_bf16_round if split_bf16 else (lambda v: v)
    bh, s, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    nc = s // q
    bg = bh // heads
    xf = x.float().reshape(bg, heads, nc, q, p)
    cumc = cum.reshape(bg, heads, nc, q)
    dtc = dt.float().reshape(bg, heads, nc, q)
    cc = C_.float().reshape(bg, 1, nc, q, n)
    bb = B_.float().reshape(bg, 1, nc, q, n)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    expnt = torch.where(causal, cumc[..., :, None] - cumc[..., None, :], float("-inf"))
    scores = torch.matmul(cc, bb.transpose(-1, -2)) * torch.exp(expnt) * dtc[..., None, :]
    y = torch.matmul(rnd(scores), xf)  # (BG,H,nc,Q,P)
    inter = torch.matmul(cc, rnd(h.reshape(bg, heads, nc, n, p)))
    y = y + torch.exp(cumc)[..., None] * inter
    y = y + D_.float().reshape(bg, heads, 1, 1, 1) * xf
    return y.to(x.dtype).reshape(bh, s, p)
