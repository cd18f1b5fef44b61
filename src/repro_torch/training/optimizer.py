"""AdamW written out, as in the reference (no ``torch.optim``), with its
mixed-precision policy.

- model params live in the model dtype (bf16 at full width);
- float32 master copy and float32 first/second moments;
- gradients arrive in the parameter dtype and are promoted to float32 only
  for the optimizer's arithmetic;
- global-norm clipping, decoupled weight decay, cosine LR with warmup.

The port of ``repro.training.optimizer``.  Trees are the port's
(:mod:`repro_torch.tree`).  :func:`adamw_step` updates the master copy, the
moments and the parameters in place, to keep one copy of the optimizer
state on the card; it returns them as the reference returns its new ones.
Weight decay applies to the leaves that are matrices *in the reference*
(``ndim >= 2``), where a layer list's leaves count the stacked layer axis:
every per-layer leaf, norm scales and ``A_log`` included, is decayed, and
only the top-level vectors (``final_norm``) are not.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import TrainConfig
from ..tree import leaf_groups, tree_map

__all__ = ["OptState", "abstract_opt_state", "init_opt_state", "adamw_step", "lr_schedule",
           "global_norm"]


class OptState(NamedTuple):
    master: dict  # fp32 master params
    m: dict       # fp32 first moment
    v: dict       # fp32 second moment
    step: torch.Tensor  # () int32, on the parameters' device


def _tensors(tree) -> list[tuple[torch.Tensor, bool]]:
    """Every tensor of a tree, with whether it sits in a layer list."""
    return [(t, stacked) for _, group, stacked in leaf_groups(tree) for t in group]


def init_opt_state(params) -> OptState:
    """Master copy and zero moments in float32 for a parameter tree."""
    # copy=True: float32 params must not alias the master buffer
    f32 = lambda p: p.detach().to(torch.float32, copy=True)  # noqa: E731
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    first, _ = _tensors(params)[0]
    return OptState(
        master=tree_map(f32, params),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        step=torch.zeros((), dtype=torch.int32, device=first.device),
    )


def abstract_opt_state(params_abstract) -> OptState:
    """The optimizer state of a parameter tree on the meta device: float32
    master/m/v of the parameters' shapes and an int32 scalar step, no storage
    (``repro/training/optimizer.py::abstract_opt_state``)."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
    return OptState(
        master=tree_map(f32, params_abstract),
        m=tree_map(f32, params_abstract),
        v=tree_map(f32, params_abstract),
        step=torch.empty((), dtype=torch.int32, device="meta"),
    )


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g, _ in _tensors(tree)))


def lr_schedule(step: torch.Tensor, hp: TrainConfig) -> torch.Tensor:
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - hp.warmup_steps) / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return hp.learning_rate * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def adamw_step(grads, params, opt: OptState, hp: TrainConfig):
    """Returns (params in the model dtype, OptState, metrics), all updated in place.

    DTensor gradients are first redistributed to the master copy's
    placements: with ZeRO-1 specs, a reduce-scatter over `data`; the updated
    master copy is then gathered into the parameters by the copy."""
    grads = tree_map(lambda g, m: g.redistribute(m.device_mesh, m.placements)
                     if isinstance(g, DTensor) else g, grads, opt.master)
    step = opt.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(hp.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) if hp.grad_clip else 1.0
    lr = lr_schedule(step, hp)
    b1, b2, eps, wd = hp.b1, hp.b2, hp.eps, hp.weight_decay
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    for (g, stacked), (p, _), (master, _), (m, _), (v, _) in zip(
            _tensors(grads), _tensors(params), _tensors(opt.master), _tensors(opt.m),
            _tensors(opt.v), strict=True):
        g32 = g.float() * clip
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        mhat = m_new / bc1
        vhat = v_new / bc2
        # decoupled weight decay only on the reference's matrices (ndim >= 2)
        decay = wd * master if master.ndim + stacked >= 2 else 0.0
        master_new = master - lr * (mhat / (torch.sqrt(vhat) + eps) + decay)
        m.copy_(m_new)
        v.copy_(v_new)
        master.copy_(master_new)
        p.copy_(master_new)  # cast to the parameter dtype
    return params, OptState(opt.master, opt.m, opt.v, step), {"grad_norm": gnorm, "lr": lr}
