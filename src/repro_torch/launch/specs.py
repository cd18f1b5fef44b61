"""Abstract inputs and sharding specs for every (arch × shape × mesh) cell:
the dry run's contract.

The port of ``repro.launch.specs``.  Nothing here allocates memory: inputs,
parameters, optimizer state and caches are tensors on the meta device, where
the reference has ``ShapeDtypeStruct``s.  Specs are the port's
:class:`~repro_torch.distributed.sharding.PartitionSpec`, in the port's trees
(a layer list where the reference stacks layers).  A mesh is read only
through its axis names and sizes, so an
:class:`~repro_torch.distributed.sharding.AbstractMesh` serves as well as a
``DeviceMesh``.

Sharding policy:
- batch over (pod, data) when divisible, else data, else replicated;
- KV cache: heads over `model` when kv_heads divides, OTHERWISE the cache
  length dim over `model` (distributed flash-decoding) when it divides —
  this is what keeps 32k caches of kv=8 archs on-chip at batch 128;
- optimizer state additionally ZeRO-1-sharded over `data`, leaf by leaf of
  the port's tree: a layer list's per-layer leaf has no layer axis, so where
  the reference's stacked leaf takes `data` on its layer axis, the port's
  takes it on the first other dimension that divides (the same bytes a
  device).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import AxisRules, NamedSharding, logical_to_spec, make_rules, mesh_sizes
from ..distributed.sharding import PartitionSpec as P
from ..distributed.zero import zero_shard_tree
from ..models import abstract_params, init_cache, logical_axes
from ..models.init import torch_dtype
from ..training.optimizer import OptState

__all__ = [
    "batch_partition",
    "rules_for",
    "param_specs",
    "opt_specs",
    "train_batch_abstract",
    "prefill_inputs_abstract",
    "cache_abstract",
    "cache_spec_tree",
    "ns",
]


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_partition(mesh, batch: int):
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    total = 1
    for a in axes:
        total *= sizes[a]
    if axes and batch % total == 0:
        return axes if len(axes) > 1 else axes[0]
    if "data" in sizes and batch % sizes["data"] == 0:
        return "data"
    return None


def rules_for(cfg: ModelConfig, mesh) -> AxisRules:
    sizes = mesh_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    return make_rules(cfg, mesh, batch_axes=batch_axes or ("data",))


def ns(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def param_specs(cfg: ModelConfig, mesh, rules: AxisRules):
    return logical_to_spec(logical_axes(cfg), rules)


def opt_specs(cfg: ModelConfig, mesh, rules: AxisRules, *, zero1: bool = True) -> OptState:
    pspecs = param_specs(cfg, mesh, rules)
    if zero1:
        zspecs = zero_shard_tree(pspecs, abstract_params(cfg).tree(), mesh, axis="data")
    else:
        zspecs = pspecs
    return OptState(master=zspecs, m=zspecs, v=zspecs, step=P())


# ------------------------------------------------------------------- batches
def train_batch_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b, s = shape.global_batch, shape.seq_len
    bp = batch_partition(mesh, b)
    dtype = torch_dtype(cfg.dtype)
    batch: dict = {"targets": _meta((b, s), torch.int32)}
    specs: dict = {"targets": P(bp, None)}
    if cfg.is_encoder_decoder:
        batch["frames"] = _meta((b, s, cfg.d_model), dtype)
        specs["frames"] = P(bp, None, None)
        batch["tokens"] = _meta((b, s), torch.int32)
        specs["tokens"] = P(bp, None)
    elif cfg.input_kind == "patches":
        batch["embeds"] = _meta((b, s, cfg.d_model), dtype)
        specs["embeds"] = P(bp, None, None)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
        specs["tokens"] = P(bp, None)
    return batch, specs


def prefill_inputs_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b, s = shape.global_batch, shape.seq_len
    bp = batch_partition(mesh, b)
    dtype = torch_dtype(cfg.dtype)
    if cfg.input_kind == "patches":
        inputs = _meta((b, s, cfg.d_model), dtype)
        spec = P(bp, None, None)
    else:
        inputs = _meta((b, s), torch.int32)
        spec = P(bp, None)
    extras = {}
    espec = {}
    if cfg.is_encoder_decoder:
        extras["enc_frames"] = _meta((b, s, cfg.d_model), dtype)
        espec["enc_frames"] = P(bp, None, None)
    return inputs, spec, extras, espec


# -------------------------------------------------------------------- caches
def cache_abstract(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int = 0) -> dict:
    return init_cache(cfg, batch, cache_len, enc_len=enc_len, device="meta")


def cache_spec_tree(cfg: ModelConfig, mesh, cache_abs: dict) -> dict:
    sizes = mesh_sizes(mesh)
    msize = sizes.get("model", 1)
    specs: dict = {}
    for name, leaf in cache_abs.items():
        shp = leaf.shape
        if name == "pos":
            specs[name] = P()
        elif name in ("k", "v", "xk", "xv", "shared_k", "shared_v"):
            # (L/sites, B, T, K, hd)
            bp = batch_partition(mesh, shp[1])
            kv = shp[3]
            t = shp[2]
            dsize = sizes.get("data", 1)
            # when the batch cannot use the data axis (e.g. long_500k B=1),
            # shard the cache LENGTH over it — distributed flash-decoding —
            # otherwise the data axis keeps replicas of the whole cache
            t_ax = "data" if (bp is None and dsize > 1 and t % dsize == 0) else None
            if msize > 1 and kv % msize == 0:
                specs[name] = P(None, bp, t_ax, "model", None)
            elif msize > 1 and t % msize == 0:
                tm = ("data", "model") if t_ax else "model"
                specs[name] = P(None, bp, tm, None, None)  # flash-decoding split
            else:
                specs[name] = P(None, bp, t_ax, None, None)
        elif name == "conv":
            bp = batch_partition(mesh, shp[1])
            specs[name] = P(None, bp, None, None)
        elif name == "ssm":
            bp = batch_partition(mesh, shp[1])
            h = shp[2]
            specs[name] = P(None, bp, "model" if msize > 1 and h % msize == 0 else None, None, None)
        elif name == "x0":
            bp = batch_partition(mesh, shp[0])
            specs[name] = P(bp, None, None)
        else:
            specs[name] = P(*([None] * len(shp)))
    return specs
