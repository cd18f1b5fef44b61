"""Logical-axis sharding: MaxText-style name indirection, on DTensor.

The port of ``repro.distributed.sharding``.  Model code annotates tensors
and parameters with *logical* axis names ("batch", "vocab", "heads",
"d_ff", "experts", ...); an :class:`AxisRules` mapping, computed per
(config, mesh) with divisibility fallbacks, resolves them to the axes of a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

JAX's ``PartitionSpec`` and ``NamedSharding`` have counterparts here of the
same names: a :class:`PartitionSpec` gives, per tensor dimension, None, a
mesh axis name or a tuple of them, and a :class:`NamedSharding` binds one to
a mesh and turns itself into DTensor placements.  ``constrain`` redistributes
a ``DTensor`` only when a rules context with a mesh is active; a plain
tensor passes unchanged, so the same model code runs unsharded on one card.

One difference from JAX, by construction of DTensor: a tensor dimension
sharded over several mesh axes (``("model", "data")``, as
:func:`repro_torch.distributed.zero.zero_shard_spec` composes them) is
split over those axes in the *mesh's* order, whatever order the spec names
them in.  The full tensor is the same; which rank holds which slice may
differ from JAX's.
"""

from __future__ import annotations

import functools
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..tree import tree_map

__all__ = [
    "AbstractMesh",
    "AxisRules",
    "NamedSharding",
    "PartitionSpec",
    "axis_rules",
    "constrain",
    "current_rules",
    "finish_partial",
    "fit_placements",
    "logical_to_spec",
    "make_rules",
    "map_shards",
    "mesh_sizes",
    "named_shardings",
]


class PartitionSpec(tuple):
    """Per tensor dimension: None (replicated), a mesh axis name, or a tuple
    of axis names; the counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts: str | tuple[str, ...] | None):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class AbstractMesh(NamedTuple):
    """Axis names and sizes of a mesh and nothing else: all that
    :func:`make_rules` and ``zero_shard_spec`` read, so rules for a
    (16, 16) mesh can be computed on one card without its devices."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` bound to a mesh."""

    mesh: Any
    spec: PartitionSpec

    def placements(self, ndim: int) -> tuple:
        """DTensor placements for a tensor of rank ``ndim``: per mesh axis,
        ``Shard(d)`` for the tensor dimension ``d`` that names it, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has {len(self.spec)} entries for a rank-{ndim} tensor")
        dim_of: dict[str, int] = {}
        for d, part in enumerate(self.spec):
            for name in _axes(part):
                if name in dim_of:
                    raise ValueError(f"{self.spec} names mesh axis {name!r} twice")
                dim_of[name] = d
        names = tuple(self.mesh.mesh_dim_names)
        unknown = sorted(set(dim_of) - set(names))
        if unknown:
            raise ValueError(f"{self.spec} names {unknown}, not axes of the mesh {names}")
        return tuple(Shard(dim_of[n]) if n in dim_of else Replicate() for n in names)


@dataclass(frozen=True)
class AxisRules:
    """logical name -> physical mesh axis (or tuple of axes, or None)."""

    rules: dict[str, tuple[str, ...] | str | None]
    mesh: Any = None

    def spec(self, *logical: str | None) -> PartitionSpec:
        return PartitionSpec(*(None if name is None else self.rules.get(name) for name in logical))

    def sharding(self, *logical: str | None) -> NamedSharding:
        if self.mesh is None:
            raise ValueError("AxisRules has no mesh bound")
        return NamedSharding(self.mesh, self.spec(*logical))


_state = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


@contextmanager
def axis_rules(rules: AxisRules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Check that ``x`` has one logical name per axis.  Under active rules
    with a mesh, a ``DTensor`` is redistributed to the rules' placements;
    anything else comes back unchanged."""
    if x.ndim != len(logical):
        raise ValueError(f"constrain: rank {x.ndim} != {len(logical)} logical names")
    r = current_rules()
    if r is None or r.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, r.mesh, fit_placements(r.sharding(*logical).placements(x.ndim), x.shape,
                                                       r.mesh))


def fit_placements(placements: tuple, shape, mesh) -> tuple:
    """``placements`` for a tensor of ``shape``, with the shards DTensor
    cannot take made ``Replicate``: those over a mesh axis of size 1, which
    split nothing, and a dimension's outermost mesh axes until the product
    of those left divides its size (as ``batch_partition`` falls back from
    (pod, data) to data to none).  XLA pads a dimension its axes do not
    divide, so that one device holds a batch of one; DTensor would split
    it unevenly, and its view rules refuse to reshape a sharded dimension of
    size 1 at all."""
    from torch.distributed.tensor import Replicate

    out = [Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(placements)]
    for d in {p.dim for p in out if p.is_shard()}:
        axes = [i for i, p in enumerate(out) if p.is_shard(d)]
        while axes and shape[d] % math.prod(mesh.size(i) for i in axes):
            out[axes.pop(0)] = Replicate()
    return tuple(out)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``, and the gradient to the same placements
    in the backward pass, as JAX's sharding constraint binds the cotangent
    too.  (DTensor's own redistribute sends the gradient back towards the
    input's placements, which it cannot do for a partial sum of another kind,
    such as the masked one of a vocab-sharded embedding lookup.)"""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def finish_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor reduced over a sharded dim is a partial sum on each rank:
    complete it on every rank (an all-reduce), where DTensor would otherwise
    scatter it over another dim at the next pointwise op.  Anything else
    comes back unchanged."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p for p in t.placements])
    return t


def map_shards(fn, args: tuple, roles: tuple, out_roles, *, lead: int = 0, **kwargs):
    """``fn(*args, **kwargs)`` for DTensor ``args``, rank by rank: for a
    function that is independent along some dims of its tensors (batch rows,
    channels, heads), each rank runs ``fn`` on its own shards
    (``torch.distributed.tensor.experimental.local_map``), with no
    collective inside.

    ``roles`` names, per argument, the tensor dim of each such axis
    (``{"batch": 0, "heads": 2}``).  The argument at ``lead`` leads: its
    sharding of its named dims is kept, and any other mesh axis of it is
    gathered.  Every argument is then sharded on the same mesh axes along
    its dims of the same names and replicated on the others; a plain tensor
    counts as replicated.  ``out_roles`` places the output (a tuple of them, the
    outputs of a function that returns a tuple).  An argument that is whole
    on an axis that splits the lead (a weight beside batch rows) takes its
    gradient there as a partial sum, completed where DTensor next needs it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = args[lead].device_mesh
    role_at = {d: r for r, d in roles[lead].items()}
    axis_role = [role_at.get(p.dim) if p.is_shard() else None for p in args[lead].placements]

    def placements(named: dict) -> tuple:
        return tuple(Shard(named[r]) if r in named else Replicate() for r in axis_role)

    def grad_placements(named: dict) -> tuple:
        # an argument whole on an axis that splits the lead serves every
        # rank's slice of it: its gradient there is a partial sum
        return tuple(Shard(named[r]) if r in named else Replicate() if r is None else Partial()
                     for r in axis_role)

    in_placements = tuple(placements(r) for r in roles)
    local_args = []
    for a, pl in zip(args, in_placements):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        local_args.append(a.redistribute(mesh, pl))
    if isinstance(out_roles, tuple):
        out_placements = tuple(list(placements(r)) for r in out_roles)
    else:
        out_placements = list(placements(out_roles))
    run = local_map(functools.partial(fn, **kwargs), out_placements=out_placements,
                    in_placements=in_placements,
                    in_grad_placements=tuple(grad_placements(r) for r in roles), device_mesh=mesh)
    return run(*local_args)


def logical_to_spec(axes_tree, rules: AxisRules):
    """Map a tree of logical-name tuples to a tree of PartitionSpecs."""
    return tree_map(lambda axes: rules.spec(*axes), axes_tree,
                    is_leaf=lambda v: isinstance(v, tuple))


def named_shardings(spec_tree, mesh):
    """A tree of PartitionSpecs bound to ``mesh``: a tree of NamedShardings,
    as ``CheckpointManager.restore(shardings=)`` takes it."""
    return tree_map(lambda spec: NamedSharding(mesh, spec), spec_tree,
                    is_leaf=lambda v: isinstance(v, PartitionSpec))


def make_rules(cfg, mesh, *, model_axis: str = "model", batch_axes: tuple[str, ...] = ("data",)) -> AxisRules:
    """Divisibility-driven rules for a ModelConfig on a mesh.

    - heads/d_ff/vocab shard over `model` when divisible, else replicate;
    - kv heads usually < model size -> replicated (GQA groups local);
    - experts shard over `model` when divisible (EP), else expert-FFN width;
    - batch over (pod, data);
    - a LoRA adapter's rank (the published Zamba2's) replicated.

    Only the mesh's axis names and sizes are read (:func:`mesh_sizes`).
    """
    msize = 1 if mesh is None else mesh_sizes(mesh).get(model_axis, 1)

    def div(n: int):
        return model_axis if (msize > 1 and n % msize == 0) else None

    rules: dict[str, tuple[str, ...] | str | None] = {
        "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "seq": None,
        "d_model": None,
        "heads": div(cfg.n_heads) if cfg.n_heads else None,
        "kv_heads": div(cfg.n_kv_heads) if cfg.n_kv_heads else None,
        "head_dim": None,
        "d_ff": div(cfg.d_ff) if cfg.d_ff else None,
        "vocab": div(cfg.padded_vocab),
        "layers": None,
        "ssm_inner": div(cfg.d_inner) if cfg.ssm.enabled else None,
        "ssm_state": None,
        "ssm_heads": div(cfg.ssm_heads) if cfg.ssm.enabled else None,
        "conv_width": None,
        # SP: the residual stream's sequence dim lives sharded on the model
        # axis between blocks (reduce-scatter replaces all-reduce)
        "seq_sp": model_axis if (cfg.seq_shard and msize > 1) else None,
    }
    if cfg.moe.enabled:
        if cfg.moe_force_ep and msize > 1 and cfg.moe.e_total % msize == 0:
            rules["experts"] = model_axis       # EP over padded expert slots
            rules["d_expert"] = None
        elif cfg.moe.e_total % msize == 0 and msize > 1:
            rules["experts"] = model_axis       # expert parallelism
            rules["d_expert"] = None
        else:
            rules["experts"] = None             # replicate experts,
            rules["d_expert"] = div(cfg.moe.d_expert)  # TP inside each expert
    else:
        rules["experts"] = None
        rules["d_expert"] = None
    if cfg.adapter_rank:  # the published Zamba2's LoRA adapters: rank 128, replicated
        rules["lora_rank"] = None
    return AxisRules(rules=rules, mesh=mesh)
