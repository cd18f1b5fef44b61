"""Public wrapper: the one-pass RMSNorm on the card, or plainly on the CPU.

:func:`rms_norm` (x (..., G * W), scale (G * W,), an optional gate z of x's
shape) normalises each of ``groups`` groups of W channels of ``x``, or of
``x * silu(z)``: without the gate at one group it is
:func:`repro_torch.models.ops.rms_norm`, with the gate
:func:`repro_torch.models.ssm.gated_norm`.  A CUDA tensor goes to the
hand-written kernel in :mod:`.kernel` (or the launch raises), any other (a
CPU tensor, or a meta tensor whose operations are counted) to that plain
version.  A DTensor's partial sums are completed first; each rank then
normalises its own rows through the kernel, unless its groups are split
across ranks, in which case the plain version completes their sums across
the ranks, and on the card that is counted in :data:`PLAIN_ON_CARD`.
Shapes the kernel does not take raise on every device.  Like the other
kernels of ``attn_impl="pallas"``, neither path has a backward here.
:data:`KERNEL_LAUNCHES` counts launches of the CUDA kernel only.
"""

from __future__ import annotations

import threading

import torch
from torch.distributed.tensor import DTensor

from ...distributed.sharding import finish_partial, map_shards
from ...models import ops as model_ops
from ...models import ssm
from .._autograd import forward_only
from .kernel import check_shapes, rms_norm_call

__all__ = ["KERNEL_LAUNCHES", "PLAIN_ON_CARD", "reset_kernel_launches", "rms_norm"]

#: launches of the CUDA kernel (the plain CPU version is not counted), by
#: whether it ran with the gate
KERNEL_LAUNCHES = {"rms_norm": 0, "gated_rms_norm": 0}
#: DTensors on the card whose groups were split across ranks, so that the
#: plain version normalised them in place of the kernel
PLAIN_ON_CARD = {"rms_norm": 0, "gated_rms_norm": 0}
_launch_mu = threading.Lock()


def reset_kernel_launches() -> None:
    with _launch_mu:
        for counts in (KERNEL_LAUNCHES, PLAIN_ON_CARD):
            for name in counts:
                counts[name] = 0


def _count(counts: dict, z: torch.Tensor | None) -> None:
    with _launch_mu:
        counts["rms_norm" if z is None else "gated_rms_norm"] += 1


def _plain(x: torch.Tensor, scale: torch.Tensor, eps: float, z: torch.Tensor | None,
           groups: int) -> torch.Tensor:
    if z is not None:
        return ssm.gated_norm(x, z, scale, groups, eps)
    if groups == 1:
        return model_ops.rms_norm(x, scale, eps)
    w = x.shape[-1] // groups
    return model_ops.rms_norm(x.reshape(*x.shape[:-1], groups, w), scale.reshape(groups, w),
                              eps).reshape(x.shape)


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float, z: torch.Tensor | None,
          groups: int) -> torch.Tensor:
    if x.device.type != "cuda":
        return _plain(x, scale, eps, z, groups)
    out = rms_norm_call(x.contiguous(), scale.contiguous(), eps,
                        z=None if z is None else z.contiguous(), groups=groups)
    _count(KERNEL_LAUNCHES, z)
    return out


def _rank_rows(x: torch.Tensor, scale: torch.Tensor, *z: torch.Tensor, eps: float,
               groups: int) -> torch.Tensor:
    return rms_norm(x, scale, eps, z[0] if z else None, groups)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, z: torch.Tensor | None = None,
             groups: int = 1) -> torch.Tensor:
    """rms_norm(x), or rms_norm(x * silu(z)), over each of ``groups`` groups
    of channels: normalised in float32, cast back, then scaled in the model
    dtype.  x, z: (..., D), scale: (D,)."""
    check_shapes(x, scale, z, groups)
    if isinstance(x, DTensor):
        x = finish_partial(x)
        z = None if z is None else finish_partial(z)
        if any(p.is_shard(x.ndim - 1) for p in x.placements):
            if x.device.type == "cuda":
                _count(PLAIN_ON_CARD, z)
            return _plain(x, scale, eps, z, groups)
        rows = {f"dim{d}": d for d in range(x.ndim - 1)}  # independent: each rank its rows
        zs = () if z is None else (z,)
        return map_shards(_rank_rows, (x, scale, *zs), (rows, {}) + (rows,) * len(zs), rows,
                          eps=eps, groups=groups)
    return forward_only("rms_norm", _norm, x, scale, eps, z, groups)
