"""Public wrapper: the one-pass RMSNorm on the card, or plainly on the CPU.

:func:`rms_norm` (x (..., G * W), scale (G * W,), an optional gate z of x's
shape) normalises each of ``groups`` groups of W channels of ``x``, or of
``x * silu(z)``, as the plain version in :mod:`.ref`, which takes the same
arguments, computes it.  A CUDA tensor goes to the hand-written kernel in
:mod:`.kernel` (or the launch raises), any other (a CPU tensor, or a meta
tensor whose operations are counted) to that plain version.  A DTensor's
partial sums are completed first; each rank then normalises its own rows
through the kernel, unless its groups are split across ranks, in which case
the plain version completes their sums across the ranks, and on the card that
is counted in :mod:`..launches` under ``rms_norm.plain_on_card``.  Shapes the
kernel does not take raise on every device.  Like the other kernels of
``attn_impl="pallas"``, neither path has a backward here.  Each launch of the
CUDA kernel is counted in :mod:`..launches` under ``rms_norm``, or under
``gated_rms_norm`` when the gate ran.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ...distributed.sharding import finish_partial, map_shards
from .. import launches
from .._autograd import forward_only
from . import ref
from .kernel import check_shapes, rms_norm_call

__all__ = ["rms_norm"]


def _name(z: torch.Tensor | None) -> str:
    return "rms_norm" if z is None else "gated_rms_norm"


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float, z: torch.Tensor | None,
          groups: int) -> torch.Tensor:
    if x.device.type != "cuda":
        return ref.rms_norm(x, scale, eps, z, groups)
    out = rms_norm_call(x.contiguous(), scale.contiguous(), eps,
                        z=None if z is None else z.contiguous(), groups=groups)
    launches.count(_name(z))
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
                launches.count(f"{_name(z)}.plain_on_card")
            return ref.rms_norm(x, scale, eps, z, groups)
        rows = {f"dim{d}": d for d in range(x.ndim - 1)}  # independent: each rank its rows
        zs = () if z is None else (z,)
        return map_shards(_rank_rows, (x, scale, *zs), (rows, {}) + (rows,) * len(zs), rows,
                          eps=eps, groups=groups)
    return forward_only("rms_norm", _norm, x, scale, eps, z, groups)
