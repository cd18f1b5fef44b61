"""Layer-stack scan as a Python loop.

The port of ``repro.models.scan``.  The reference scans layer-stacked
leaves with ``lax.scan`` and unrolls into a Python loop on request, so that
a layer index arrives as a concrete int and ``maybe_cond`` can prune the
branch not taken.  PyTorch runs eagerly, so both modes are the Python loop
here: ``unroll`` is accepted for the reference's signature and changes
nothing, and every ``maybe_cond`` whose predicate is concrete takes one
branch.

``xs`` is what the layers consume, one entry per layer: a layer list (the
port's ``params["blocks"]``, a list or ``ModuleList`` of per-layer
parameters), a tensor or a dict of tensors stacked on a leading layer axis,
a plain list (layer indices), or a tuple of any of these, indexed together.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

from ..tree import tree_map

__all__ = ["layer_scan", "maybe_cond"]


def layer_scan(body, carry, xs, *, unroll: bool = False, length: int | None = None):
    """``carry, y = body(carry, x)`` for each layer's ``x`` of ``xs``, in
    order -> (final carry, the ``y``s stacked on a leading axis, or None
    when ``body`` returns None)."""
    del unroll  # eager: the loop is always unrolled
    n = _length(xs) if length is None else length
    ys = []
    for i in range(n):
        carry, y = body(carry, _index(xs, i))
        ys.append(y)
    if ys and ys[0] is not None:
        return carry, tree_map(lambda *ls: torch.stack(ls), *ys)
    return carry, None


def _index(x, i: int):
    if isinstance(x, tuple):
        return tuple(_index(v, i) for v in x)
    if isinstance(x, Mapping):
        return {k: _index(v, i) for k, v in x.items()}
    if isinstance(x, (torch.Tensor, Sequence, torch.nn.ModuleList)):
        return x[i]
    return x


def _length(xs) -> int:
    if isinstance(xs, tuple):
        return _length(xs[0])
    if isinstance(xs, Mapping):
        return _length(next(iter(xs.values())))
    return len(xs)


def maybe_cond(pred, true_fn, false_fn, operand):
    """``true_fn(operand)`` if ``pred`` else ``false_fn(operand)``, for a
    Python bool, a numpy bool or a 0-d tensor."""
    if isinstance(pred, torch.Tensor) and pred.ndim != 0:
        raise ValueError(f"maybe_cond takes a scalar predicate, got shape {tuple(pred.shape)}")
    return true_fn(operand) if bool(pred) else false_fn(operand)
