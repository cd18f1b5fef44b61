"""Trees of tensors, named as the reference's pytrees are named.

The port holds a model's parameters and optimizer state as nested dicts and
NamedTuples of tensors, the shape of the reference's pytrees, with one
difference: where the reference keeps a layer-stacked leaf of shape
(L, ...) under ``blocks``, the port keeps a *layer list*, a list of L
per-layer dicts of tensors (``ModelParams.tree()``).  :func:`leaf_groups`
names every leaf as the reference's checkpoint names it
(``jax.tree_util.keystr`` with brackets and quotes turned into dots:
``params.blocks.w_x``, ``opt.master.embed``, ``opt.step``) and gives, for a
layer-stacked name, the per-layer tensors in layer order.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

__all__ = ["is_layer_list", "is_namedtuple", "leaf_groups", "leaf_name", "tree_map"]


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def is_layer_list(node) -> bool:
    """A list of per-layer dicts: the counterpart of layer-stacked leaves."""
    return isinstance(node, list) and bool(node) and all(isinstance(x, Mapping) for x in node)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def leaf_name(path: str) -> str:
    """The reference's checkpoint name of the leaf at a dotted path."""
    return path.strip(".").replace("/", "_") or "root"


def leaf_groups(tree, prefix: str = "") -> list[tuple[str, list[Any], bool]]:
    """Every leaf as ``(reference name, tensors, stacked)``.

    A plain leaf gives one tensor and ``stacked=False``; a key of a layer
    list gives its L per-layer tensors, which the reference holds as one
    (L, ...) leaf, and ``stacked=True``.  Dict keys are visited in sorted
    order, as JAX flattens dicts; trees of one structure give their groups in
    the same order."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += leaf_groups(tree[k], f"{prefix}.{k}")
        return out
    if is_namedtuple(tree):
        out = []
        for field, value in zip(tree._fields, tree):
            out += leaf_groups(value, f"{prefix}.{field}")
        return out
    if is_layer_list(tree):
        keys = sorted(tree[0])
        for layer in tree[1:]:
            if sorted(layer) != keys:
                raise ValueError(f"{leaf_name(prefix)}: layers hold different keys")
        return [(leaf_name(f"{prefix}.{k}"), [layer[k] for layer in tree], True) for k in keys]
    if isinstance(tree, (list, tuple)):
        out = []
        for i, value in enumerate(tree):
            out += leaf_groups(value, f"{prefix}.{i}")
        return out
    return [(leaf_name(prefix), [tree], False)]
