"""Leaf-array (de)serialization for FDB-backed checkpoints.

Each parameter leaf travels as one FDB field in the reference's ``RPR1``
format: the magic, a 4-byte big-endian header length, a JSON header
(``dtype``, ``shape``) and the raw bytes.  bf16 travels under the dtype
name ``"bfloat16"`` as its raw 16-bit words, which is what the reference
writes and reads through ``ml_dtypes``; the port reads them through an
int16 view and needs no ``ml_dtypes``.  Leaves are named as the reference
names them (:mod:`repro_torch.tree`), and a layer list is written as one
layer-stacked (L, ...) leaf, so a checkpoint written by either package
restores in the other.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np
import torch

from ..tree import is_layer_list, is_namedtuple, leaf_groups, leaf_name

__all__ = ["encode_array", "decode_array", "flatten_tree", "unflatten_tree"]

_MAGIC = b"RPR1"


def _as_tensor(x) -> torch.Tensor:
    """A CPU tensor holding ``x`` (tensor, numpy array or scalar), sharing memory
    with it where it can."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16 from the reference
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def encode_array(x) -> bytes:
    t = _as_tensor(x).contiguous()
    if t.dtype == torch.bfloat16:
        name, arr = "bfloat16", t.view(torch.int16).numpy()
    else:
        arr = t.numpy()
        name = arr.dtype.name
    header = json.dumps({"dtype": name, "shape": list(arr.shape)}).encode()
    return _MAGIC + len(header).to_bytes(4, "big") + header + arr.tobytes()


def decode_array(raw: bytes) -> torch.Tensor:
    """An ``RPR1`` field -> a CPU tensor of its dtype and shape."""
    if raw[:4] != _MAGIC:
        raise ValueError("bad checkpoint field magic")
    hlen = int.from_bytes(raw[4:8], "big")
    header = json.loads(raw[8: 8 + hlen].decode())
    body = memoryview(raw)[8 + hlen:]
    if header["dtype"] == "bfloat16":
        words = np.frombuffer(body, dtype=np.int16).reshape(header["shape"]).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    arr = np.frombuffer(body, dtype=np.dtype(header["dtype"])).reshape(header["shape"]).copy()
    return torch.from_numpy(arr)


def _structure(tree) -> str:
    """A short description of a tree's structure, for the manifest."""
    if isinstance(tree, Mapping):
        return "{" + ", ".join(f"{k}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if is_layer_list(tree):
        return f"[{len(tree)} x {_structure(tree[0])}]"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def flatten_tree(tree) -> tuple[dict[str, torch.Tensor], dict]:
    """tree -> ({name: leaf}, manifest), every leaf a host copy.

    The copies are snapshots: later in-place updates of the tree (the
    optimizer's) do not reach them.  A layer list's per-layer tensors are
    copied into one (L, ...) host tensor per name."""
    leaves: dict[str, torch.Tensor] = {}
    for name, group, stacked in leaf_groups(tree):
        if name in leaves:
            raise ValueError(f"two leaves are named {name!r}")
        if stacked:
            first = _as_tensor(group[0])
            out = torch.empty((len(group), *first.shape), dtype=first.dtype)
            for i, t in enumerate(group):
                out[i].copy_(_as_tensor(t))
            leaves[name] = out
        elif isinstance(group[0], torch.Tensor):
            leaves[name] = group[0].detach().to("cpu", copy=True)
        else:
            leaves[name] = _as_tensor(group[0]).clone()
    manifest = {"treedef": _structure(tree), "names": list(leaves)}
    return leaves, manifest


def unflatten_tree(template, leaves_by_name: Mapping[str, Any]):
    """Rebuild ``template``'s structure from leaves by name (elastic-safe);
    a layer list takes its per-layer tensors from one (L, ...) leaf."""

    def get(path: str):
        name = leaf_name(path)
        if name not in leaves_by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        return _as_tensor(leaves_by_name[name])

    def rebuild(node, path: str):
        if isinstance(node, Mapping):
            return {k: rebuild(v, f"{path}.{k}") for k, v in node.items()}
        if is_namedtuple(node):
            return type(node)(*(rebuild(v, f"{path}.{f}") for f, v in zip(node._fields, node)))
        if is_layer_list(node):
            stacked = {k: get(f"{path}.{k}") for k in node[0]}
            for k, t in stacked.items():
                if t.ndim == 0 or t.shape[0] != len(node):
                    raise ValueError(f"checkpoint leaf {leaf_name(f'{path}.{k}')} holds {tuple(t.shape)}, "
                                     f"not {len(node)} layers")
            return [{k: t[i] for k, t in stacked.items()} for i in range(len(node))]
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{path}.{i}") for i, v in enumerate(node))
        return get(path)

    return rebuild(template, "")
