"""The mixer's causal convolution in plain PyTorch: what the kernel computes.

``repro_torch.models.ssm.causal_conv1d`` is this function, the counterpart of
``repro.models.ssm.causal_conv1d``; the wrapper in :mod:`.ops` sends a CPU
tensor here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ...distributed.sharding import map_shards

__all__ = ["CONV_ROLES", "causal_conv1d"]

#: the convolution's independent axes: batch rows and channels of x, w and bias
CONV_ROLES = ({"batch": 0, "chan": 2}, {"chan": 1}, {"chan": 0})


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C) -> (B,S,C), silu applied.

    ``F.conv1d`` with one group per channel over a left pad of K-1, weight
    ``w.T[:, None, :]``; like JAX's convolution it is a cross-correlation, so
    neither flips the kernel."""
    if isinstance(x, DTensor):  # independent per batch row and channel: each rank its shards
        return map_shards(causal_conv1d, (x, w, bias), CONV_ROLES, CONV_ROLES[0])
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))  # (B,C,S+K-1)
    out = F.conv1d(xp, w.T[:, None, :].to(x.dtype), groups=c).transpose(1, 2)
    return F.silu(out + bias.to(x.dtype))
