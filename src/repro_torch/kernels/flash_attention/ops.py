"""Public wrapper: GQA flash attention on the card, or plainly on the CPU.

The transposes and reshapes of the reference's ``ops.flash_attention`` are
part of the contract: q (B, Sq, K, G, d) and k, v (B, Sk, K, d) are
flattened to the kernel's (B*K*G, Sq, d) and (B*K, Sk, d), and the result
comes back as (B, Sq, K, G, d).  A CPU tensor goes to the plain version in
:mod:`.ref`, a CUDA tensor to the hand-written kernel in :mod:`.kernel` (or
the launch raises).  Neither has a backward: the reference kernel has no
VJP.  :data:`KERNEL_LAUNCHES` counts launches of the CUDA kernel only, and
:data:`INSTANCE_LAUNCHES` the same launches by the instance that ran them.
"""

from __future__ import annotations

import threading

import torch

from .._autograd import forward_only
from .kernel import INSTANCES, flash_attention_call, instance_for
from .ref import flash_attention_ref

__all__ = ["INSTANCE_LAUNCHES", "KERNEL_LAUNCHES", "flash_attention", "reset_kernel_launches"]

#: launches of the CUDA kernel (the plain CPU version is not counted)
KERNEL_LAUNCHES = {"flash_attention": 0}
#: the same launches, by the kernel instance that ran them
INSTANCE_LAUNCHES = dict.fromkeys(INSTANCES, 0)
_launch_mu = threading.Lock()


def reset_kernel_launches() -> None:
    with _launch_mu:
        KERNEL_LAUNCHES["flash_attention"] = 0
        for name in INSTANCE_LAUNCHES:
            INSTANCE_LAUNCHES[name] = 0


def _attend(qf, kf, vf, groups: int, causal: bool, q_offset: int) -> torch.Tensor:
    if qf.device.type == "cpu":
        return flash_attention_ref(qf, kf, vf, groups=groups, causal=causal, q_offset=q_offset)
    out = flash_attention_call(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                               groups=groups, causal=causal, q_offset=q_offset)
    with _launch_mu:
        KERNEL_LAUNCHES["flash_attention"] += 1
        INSTANCE_LAUNCHES[instance_for(qf.dtype, qf.shape[-1])] += 1
    return out


def flash_attention(
    q: torch.Tensor,  # (B, Sq, K, G, d)
    k: torch.Tensor,  # (B, Sk, K, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    if q_offset < 0:  # a row could then see no key; the Pallas grid would skip it
        raise ValueError(f"flash_attention takes q_offset >= 0, got {q_offset}")
    b, sq, kh, g, d = q.shape
    sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * kh * g, sq, d)
    kf = k.permute(0, 2, 1, 3).reshape(b * kh, sk, d)
    vf = v.permute(0, 2, 1, 3).reshape(b * kh, sk, d)
    out = forward_only("flash_attention", _attend, qf, kf, vf, g, causal, q_offset)
    return out.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
