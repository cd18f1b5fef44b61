"""Public wrapper: the mixer's causal convolution on the card, or plainly on the CPU.

x (B, S, C), w (K, C) and bias (C,) -> ``silu(causal depthwise conv + bias)``
(B, S, C), as :func:`repro_torch.models.ssm.causal_conv1d` computes it.  A
CPU tensor goes to that plain version, a CUDA tensor to the hand-written
kernel in :mod:`.kernel` (or the launch raises); the weights and bias are
cast to x's type first, as the plain version casts them.  A DTensor is
convolved shard by shard, each rank its batch rows and channels.  Like the
other kernels of ``attn_impl="pallas"``, neither path has a backward here.
:data:`KERNEL_LAUNCHES` counts launches of the CUDA kernel only.
"""

from __future__ import annotations

import threading

import torch
from torch.distributed.tensor import DTensor

from ...distributed.sharding import map_shards
from ...models import ssm
from .._autograd import forward_only
from .kernel import causal_conv1d_call

__all__ = ["KERNEL_LAUNCHES", "causal_conv1d", "reset_kernel_launches"]

#: launches of the CUDA kernel (the plain CPU version is not counted)
KERNEL_LAUNCHES = {"causal_conv1d": 0}
_launch_mu = threading.Lock()


def reset_kernel_launches() -> None:
    with _launch_mu:
        KERNEL_LAUNCHES["causal_conv1d"] = 0


def _conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ssm.causal_conv1d(x, w, bias)
    out = causal_conv1d_call(x.contiguous(), w.to(x.dtype).contiguous(),
                             bias.to(x.dtype).contiguous())
    with _launch_mu:
        KERNEL_LAUNCHES["causal_conv1d"] += 1
    return out


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv with bias and silu. x: (B,S,C), w: (K,C) -> (B,S,C)."""
    if isinstance(x, DTensor):  # independent per batch row and channel: each rank its shards
        return map_shards(causal_conv1d, (x, w, bias), ssm.CONV_ROLES, ssm.CONV_ROLES[0])
    return forward_only("causal_conv1d", _conv, x, w, bias)
