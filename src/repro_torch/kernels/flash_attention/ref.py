"""The plain PyTorch version of the flash-attention kernel.

It computes what the Pallas kernel body computes
(``repro.kernels.flash_attention.kernel.flash_attention_kernel``), not what
the reference's oracle ``attention_ref`` computes: q, k and v are upcast to
float32, scores are scaled by ``1/sqrt(d)`` (or the ``scale`` given), masked entries take the finite
``-1e30``, the softmax denominator is ``max(l, 1e-37)``, P.V is taken in
float32 from an unrounded P, and the result is cast to the q dtype.  It
takes the kernel's flattened layout and shares each KV head among
``groups`` query rows by broadcasting, without copying K or V.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "flash_attention_ref_blocked"]

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (BH, Sq, d)  BH = batch*kv_heads*groups
    k: torch.Tensor,  # (BK, Sk, d)  BK = batch*kv_heads
    v: torch.Tensor,
    *,
    groups: int,
    causal: bool,
    q_offset: int = 0,
    round_p: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    bh, sq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bk, sk, _ = k.shape
    qf = q.float().reshape(bk, groups, sq, d)
    kf = k.float()[:, None]
    vf = v.float()[:, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # (BK, G, Sq, Sk)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(torch.bfloat16).float() if round_p else p
    out = torch.matmul(pv, vf) / torch.clamp(l, min=1e-37)
    return out.reshape(bh, sq, d).to(q.dtype)


def flash_attention_ref_blocked(
    q: torch.Tensor,  # (BH, Sq, d)  BH = batch*kv_heads*groups
    k: torch.Tensor,  # (BK, Sk, d)  BK = batch*kv_heads
    v: torch.Tensor,
    *,
    groups: int,
    causal: bool,
    key_block: int,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """The plain version in the bf16 wgmma instance's order: keys in blocks of
    ``key_block``, each block's P taken at the row's running max (2^x of the
    scores times ``scale * log2(e)``) and rounded to bf16 for P.V, the row sum
    from the unrounded P, O and the sum rescaled as the max rises.  Where a
    row's max rises after its first block, P is rounded at a smaller max than
    ``flash_attention_ref(round_p=True)`` rounds it at, so the two differ by
    more than the output's rounding."""
    bh, sq, d = q.shape
    c = (1.0 / math.sqrt(d) if scale is None else scale) * math.log2(math.e)
    bk, sk, _ = k.shape
    qf = q.float().reshape(bk, groups, sq, d)
    kf = k.float()[:, None]
    vf = v.float()[:, None]
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((bk, groups, sq, 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((bk, groups, sq, d), device=q.device)
    for k0 in range(0, sk, key_block):
        s = torch.matmul(qf, kf[:, :, k0:k0 + key_block].transpose(-1, -2)) * c
        if causal:
            k_pos = torch.arange(k0, min(k0 + key_block, sk), device=q.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)  # a row with no key yet
        alpha = torch.exp2(m - m_safe)
        p = torch.exp2(s - m_safe)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + key_block])
        m = m_new
    return (o / torch.clamp(l, min=1e-37)).reshape(bh, sq, d).to(q.dtype)
