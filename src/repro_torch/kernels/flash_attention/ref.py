"""The plain PyTorch version of the flash-attention kernel.

It computes what the Pallas kernel body computes
(``repro.kernels.flash_attention.kernel.flash_attention_kernel``), not what
the reference's oracle ``attention_ref`` computes: q, k and v are upcast to
float32, scores are scaled by ``1/sqrt(d)``, masked entries take the finite
``-1e30``, the softmax denominator is ``max(l, 1e-37)``, P.V is taken in
float32 from an unrounded P, and the result is cast to the q dtype.  It
takes the kernel's flattened layout and shares each KV head among
``groups`` query rows by broadcasting, without copying K or V.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "flash_attention_ref"]

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
) -> torch.Tensor:
    bh, sq, d = q.shape
    bk, sk, _ = k.shape
    qf = q.float().reshape(bk, groups, sq, d)
    kf = k.float()[:, None]
    vf = v.float()[:, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # (BK, G, Sq, Sk)
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
