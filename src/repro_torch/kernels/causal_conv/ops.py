"""Public wrapper: the mixer's causal convolution on the card, or plainly on the CPU.

x (B, S, C), w (K, C) and bias (C,) -> ``silu(causal depthwise conv + bias)``
(B, S, C), as the plain version in :mod:`.ref` computes it.  A CPU tensor
goes to that plain version, a CUDA tensor to the hand-written kernel in
:mod:`.kernel` (or the launch raises); the weights and bias are cast to x's
type first, as the plain version casts them.  A DTensor is convolved shard by
shard, each rank its batch rows and channels.  Like the other kernels of
``attn_impl="pallas"``, neither path has a backward here.  Each launch of the
CUDA kernel is counted in :mod:`..launches` under ``causal_conv1d``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ...distributed.sharding import map_shards
from .. import launches
from .._autograd import forward_only
from . import ref
from .kernel import causal_conv1d_call

__all__ = ["causal_conv1d"]


def _conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.causal_conv1d(x, w, bias)
    out = causal_conv1d_call(x.contiguous(), w.to(x.dtype).contiguous(),
                             bias.to(x.dtype).contiguous())
    launches.count("causal_conv1d")
    return out


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv with bias and silu. x: (B,S,C), w: (K,C) -> (B,S,C)."""
    if isinstance(x, DTensor):  # independent per batch row and channel: each rank its shards
        return map_shards(causal_conv1d, (x, w, bias), ref.CONV_ROLES, ref.CONV_ROLES[0])
    return forward_only("causal_conv1d", _conv, x, w, bias)
