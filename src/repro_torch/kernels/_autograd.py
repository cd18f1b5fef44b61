"""Forward-only kernels refuse gradients, as the reference's do.

The reference wraps neither Pallas kernel in ``jax.custom_vjp``, so
``jax.grad`` through ``attn_impl="pallas"`` raises there.  A kernel that fills
its output through a ctypes launch leaves no autograd history, so without
this wrapper ``backward()`` would silently drop the kernel's share of every
gradient.  :func:`forward_only` runs a kernel's launch (or, for a CPU tensor,
its plain version) inside an ``autograd.Function`` whose backward raises, on
the card and on the CPU alike.  Forward calls under grad mode still work.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["forward_only"]


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, name: str, fn: Callable, *args):
        ctx.kernel_name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.kernel_name} has no backward: the reference kernel has no VJP, so "
            "nothing trains through it; train with attn_impl other than 'pallas'"
        )


def forward_only(name: str, fn: Callable, *args) -> torch.Tensor:
    """``fn(*args)``, with a backward that raises NotImplementedError."""
    return _ForwardOnly.apply(name, fn, *args)
