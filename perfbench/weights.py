"""Weights made from the seed on the device, in a few large calls.

The reference module of the configuration's family names every parameter and
how it is drawn (its ``param_shapes``: shape, kind, argument); this module
draws them all from one ``torch.Generator`` on the device.  Normal leaves
(argument: the standard deviation) come from a few large ``randn`` calls into
one flat buffer in the model dtype, each leaf a view of it; the uniform
kinds (``uniform`` in [-bound, bound], ``a_log`` = log A for A uniform in a
range, ``dt_bias`` = the inverse softplus of a log-uniform dt) from one
``rand`` call; ``ones``, ``zeros`` and ``ones32`` (float32) are filled.  The
same seed gives the same values on every run, and both sides get them.
"""

from __future__ import annotations

import math

import torch

PIECE = 1 << 26  # normal draws per randn call (256 MiB of float32 scratch)
ALIGN = 64  # each leaf starts on a 128-byte boundary of the flat buffer


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, (*path, i))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def _uniform_leaf(kind: str, arg, u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if kind == "uniform":
        return ((2 * u - 1) * arg).to(dtype)
    if kind == "a_log":
        lo, hi = arg
        return torch.log(lo + (hi - lo) * u)  # A_log stays float32
    lo, hi, floor = arg  # dt_bias
    dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo)).clamp(min=floor)
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)


def make(shapes: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The tree of ``shapes`` ((shape, kind, argument) leaves) filled from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = _skeleton(shapes)
    leaves = list(_walk(shapes))
    normal = [(path, shape, std) for path, (shape, kind, std) in leaves if kind == "normal"]
    offsets, total = [], 0
    for _, shape, _ in normal:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    pos, i = 0, 0
    while pos < total:
        n = min(PIECE, total - pos)
        piece = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
        while i < len(normal) and offsets[i] < pos + n:
            _, shape, std = normal[i]
            end = offsets[i] + math.prod(shape)
            lo, hi = max(offsets[i], pos), min(end, pos + n)
            if hi > lo:
                flat[lo:hi] = (piece[lo - pos:hi - pos] * std).to(dtype)
            if end > pos + n:
                break  # the leaf goes on in the next piece
            i += 1
        pos += n
    for (path, shape, _), off in zip(normal, offsets):
        _put(out, path, flat[off:off + math.prod(shape)].view(shape))
    uniform = [(path, shape, kind, arg) for path, (shape, kind, arg) in leaves
               if kind in ("uniform", "a_log", "dt_bias")]
    u = torch.rand(sum(math.prod(s) for _, s, _, _ in uniform), generator=gen, dtype=torch.float32,
                   device=device)
    off = 0
    for path, shape, kind, arg in uniform:
        n = math.prod(shape)
        _put(out, path, _uniform_leaf(kind, arg, u[off:off + n], dtype).view(shape))
        off += n
    fills = {"ones": (1.0, dtype), "zeros": (0.0, dtype), "ones32": (1.0, torch.float32)}
    for path, (shape, kind, _) in leaves:
        if kind in fills:
            value, dt = fills[kind]
            _put(out, path, torch.full(shape, value, dtype=dt, device=device))
    return out


def cast(tree, dtype: torch.dtype):
    """A copy of the tree with every leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype)
