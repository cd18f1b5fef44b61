"""RMSNorm in plain PyTorch, gated or not, over groups of channels: what the kernel computes.

``repro_torch.models.ops.rms_norm`` is this function, the counterpart of
``repro.models.ops.rms_norm`` (which takes neither ``z`` nor ``groups``); the
Mamba2 mixer's gated norm (Zamba2's over groups) is the same function with the
gate and its group count.  The wrapper in :mod:`.ops` takes the same arguments
and sends a tensor off the card here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ...distributed.sharding import finish_partial

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, z: torch.Tensor | None = None,
             groups: int = 1) -> torch.Tensor:
    """rms_norm(x), or rms_norm(x * silu(z)), over each of ``groups`` groups
    of channels: normalised in float32, cast back, then scaled in the model
    dtype.  x, z: (..., D), scale: (D,)."""
    if z is not None:
        x = x * F.silu(z)
    if groups > 1:
        *lead, d = x.shape
        w = d // groups
        return rms_norm(x.reshape(*lead, groups, w), scale.reshape(groups, w), eps).reshape(*lead, d)
    if isinstance(x, DTensor):  # partial sums completed first; a sharded width's sum too
        x = finish_partial(x)
        if any(p.is_shard(x.ndim - 1) for p in x.placements):
            x32 = x.float()
            var = finish_partial(torch.sum(x32 * x32, dim=-1, keepdim=True)) / x.shape[-1]
            return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale
