"""Step builders: the train step, the serving prefill and the decode step,
with their sharding contracts.

The port of ``repro.launch.steps``.  Each builder returns ``(fn, args,
in_shardings, out_shardings, donate)``: ``fn`` an eager callable that runs
under ``axis_rules`` of the cell's rules, ``args`` its arguments on the meta
device (:mod:`.specs`), and the shardings as trees of
:class:`~repro_torch.distributed.sharding.NamedSharding` in the layout of
``args``.  The dry run (:mod:`.dryrun`) turns ``args`` into fake DTensors
with those shardings and traces ``fn``; on a real mesh the caller passes
concrete tensors of the same shapes (plain tensors on a one-device mesh,
where every placement is ``Replicate``).

PyTorch has no buffer donation: ``donate`` keeps the reference's indices
(the arguments whose buffers the step may reuse) and nothing acts on them.
The port's steps update in place instead: the train step updates the
parameters and optimizer state it is given (``adamw_step``), and prefill
and decode write into the cache they are given, which they return.
"""

from __future__ import annotations

import contextlib

import torch

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..distributed.sharding import PartitionSpec as P
from ..distributed.sharding import AxisRules, axis_rules, fit_placements, named_shardings
from ..models import ModelParams, abstract_params, decode_step, prefill, train_loss
from ..training.optimizer import abstract_opt_state, adamw_step
from ..tree import tree_map
from . import specs as S

__all__ = ["build_train_step", "build_prefill", "build_decode", "build_cell", "shard_args"]


@contextlib.contextmanager
def _sharded(rules: AxisRules):
    """The cell's rules, and plain tensors made inside the step (positions,
    masks) taken as replicated beside DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    with axis_rules(rules), implicit_replication():
        yield


def _grads(params, accum: int):
    """The parameters' accumulated gradients as a tree, over ``accum``."""
    def grad(p):
        g = p.grad if p.grad is not None else p.new_zeros(p.shape)
        return g / accum if accum > 1 else g

    return tree_map(grad, params.tree())


def build_train_step(cfg: ModelConfig, hp: TrainConfig, mesh, shape: ShapeConfig):
    rules = S.rules_for(cfg, mesh)

    accum = max(1, hp.grad_accum)

    def train_step(params, opt, batch):
        with _sharded(rules):
            params.requires_grad_(True)
            params.zero_grad(set_to_none=True)
            if accum == 1:
                loss, metrics = train_loss(params, cfg, batch)
                loss.backward()
            else:
                # sequential microbatching: peak activation memory scales
                # with B/accum; grads accumulate in param dtype (bf16 wire)
                micro = {k: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
                         for k, x in batch.items()}
                loss = 0.0
                for i in range(accum):  # Python-unrolled, as the reference's
                    l, metrics = train_loss(params, cfg, {k: x[i] for k, x in micro.items()})
                    l.backward()
                    loss = loss + l.detach() / accum
            grads = _grads(params, accum)
            params.zero_grad(set_to_none=True)
            _, new_opt, om = adamw_step(grads, params.tree(), opt, hp)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, new_opt, {"loss": loss.detach(), **metrics, **om}

    pabs = abstract_params(cfg)
    oabs = abstract_opt_state(pabs.tree())
    batch_abs, batch_specs = S.train_batch_abstract(cfg, shape, mesh)
    pspecs = S.param_specs(cfg, mesh, rules)
    ospecs = S.opt_specs(cfg, mesh, rules, zero1=hp.zero1)
    in_shardings = (named_shardings(pspecs, mesh), named_shardings(ospecs, mesh),
                    named_shardings(batch_specs, mesh))
    out_shardings = (in_shardings[0], in_shardings[1], S.ns(mesh, P()))
    args = (pabs, oabs, batch_abs)
    return train_step, args, in_shardings, out_shardings, (0, 1)


def _logits_spec(mesh, b: int) -> P:
    return P(S.batch_partition(mesh, b), "model" if S.mesh_sizes(mesh).get("model", 1) > 1 else None)


def build_prefill(cfg: ModelConfig, mesh, shape: ShapeConfig):
    rules = S.rules_for(cfg, mesh)
    b, s = shape.global_batch, shape.seq_len
    inputs_abs, in_spec, extras, espec = S.prefill_inputs_abstract(cfg, shape, mesh)
    cache_abs = S.cache_abstract(cfg, b, cache_len=s, enc_len=s if cfg.is_encoder_decoder else 0)
    cspecs = S.cache_spec_tree(cfg, mesh, cache_abs)

    if cfg.is_encoder_decoder:
        def serve_prefill(params, inputs, cache, enc_frames):
            with _sharded(rules):
                return prefill(params, cfg, inputs, cache, enc_frames=enc_frames)
    else:
        def serve_prefill(params, inputs, cache):
            with _sharded(rules):
                return prefill(params, cfg, inputs, cache)

    pspecs = S.param_specs(cfg, mesh, rules)
    in_shardings = [named_shardings(pspecs, mesh), S.ns(mesh, in_spec), named_shardings(cspecs, mesh)]
    args = [abstract_params(cfg), inputs_abs, cache_abs]
    if cfg.is_encoder_decoder:
        in_shardings.append(S.ns(mesh, espec["enc_frames"]))
        args.append(extras["enc_frames"])
    out_shardings = (S.ns(mesh, _logits_spec(mesh, b)), named_shardings(cspecs, mesh))
    return serve_prefill, tuple(args), tuple(in_shardings), out_shardings, (2,)


def build_decode(cfg: ModelConfig, mesh, shape: ShapeConfig):
    rules = S.rules_for(cfg, mesh)
    b, s = shape.global_batch, shape.seq_len
    cache_abs = S.cache_abstract(cfg, b, cache_len=s, enc_len=s if cfg.is_encoder_decoder else 0)
    cspecs = S.cache_spec_tree(cfg, mesh, cache_abs)

    def serve_step(params, token, cache):
        with _sharded(rules):
            return decode_step(params, cfg, token, cache)

    pspecs = S.param_specs(cfg, mesh, rules)
    bp = S.batch_partition(mesh, b)
    token_abs = torch.empty((b, 1), dtype=torch.int32, device="meta")
    in_shardings = (named_shardings(pspecs, mesh), S.ns(mesh, P(bp, None)),
                    named_shardings(cspecs, mesh))
    out_shardings = (S.ns(mesh, _logits_spec(mesh, b)), named_shardings(cspecs, mesh))
    args = (abstract_params(cfg), token_abs, cache_abs)
    return serve_step, args, in_shardings, out_shardings, (2,)


def shard_args(args, in_shardings) -> tuple:
    """A builder's arguments as DTensors with the placements of its
    ``in_shardings`` on their (real) mesh (``fit_placements``): every rank
    passes the whole of each tensor and keeps its own shards
    (``distribute_tensor``).  A
    :class:`~repro_torch.models.ModelParams` comes back as one over DTensors."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, sh):
        return distribute_tensor(t.detach(), sh.mesh,
                                 fit_placements(sh.placements(t.ndim), t.shape, sh.mesh))

    is_tensor = lambda v: isinstance(v, torch.Tensor)  # noqa: E731
    return tuple(ModelParams.from_tree(tree_map(put, a.tree(), s, is_leaf=is_tensor))
                 if isinstance(a, ModelParams) else tree_map(put, a, s, is_leaf=is_tensor)
                 for a, s in zip(args, in_shardings))


def build_cell(cfg: ModelConfig, mesh, shape: ShapeConfig, hp: TrainConfig | None = None):
    """Dispatch on the shape kind."""
    if shape.kind == "train":
        return build_train_step(cfg, hp or TrainConfig(), mesh, shape)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape)
    if shape.kind == "decode":
        return build_decode(cfg, mesh, shape)
    raise ValueError(shape.kind)
