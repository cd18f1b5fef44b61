"""Mixture-of-Experts layer: top-k routing and GShard-style capacity dispatch.

The counterparts of ``repro.models.moe``'s functions of the same names.
Dispatch and combine are one-hot (group, expert, capacity) tensors and the
expert FFN runs as einsums over them, as in the reference: plain products
that the reference computes outside any Pallas kernel.  The per-choice loop
keeps the largest transient at (G, E, C) rather than (G, K, E, C).

DTensors take :func:`_sharded_moe_ffn`, which runs the same routing and
einsums rank by rank where the reference leaves the dispatch to GSPMD's
all-to-alls; plain tensors run the plain code, bit for bit.

Ties between router probabilities may be broken differently by
``torch.topk`` and ``jax.lax.top_k``; float32 router logits of random inputs
have none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import MoEConfig
from ..distributed.sharding import constrain, finish_partial

__all__ = ["moe_ffn", "router_topk"]


def _route(logits: torch.Tensor, moe: MoEConfig, capacity: int):
    """:func:`router_topk`'s dispatch and combine, with the one-hot choices
    (..., G, K, E) and the probabilities (..., G, E) its aux loss reads."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, moe.top_k, dim=-1)  # (..., G, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # per-expert running count in token-major, choice-minor order
    onehot = F.one_hot(gate_idx, e).int()  # (..., G, K, E)
    shp = onehot.shape
    flat = onehot.reshape(*shp[:-3], shp[-3] * shp[-2], e)  # (..., G*K, E)
    pos = (torch.cumsum(flat, dim=-2) - flat).reshape(shp)  # position among the expert's tokens
    slots = torch.arange(capacity, device=logits.device)

    dispatch = None
    combine = None
    for k in range(moe.top_k):
        oh_k = onehot[..., k, :]                      # (..., G, E)
        pos_k = (pos[..., k, :] * oh_k).sum(-1)       # (..., G) slot for this choice
        within = (pos[..., k, :] < capacity) & (oh_k > 0)  # (..., G, E)
        # a slot past the capacity is all zeros, as jax.nn.one_hot makes it
        slot = (pos_k[..., None] == slots).float()    # (..., G, C)
        d_k = within[..., :, None] * slot[..., None, :]  # (..., G, E, C)
        c_k = d_k * gate_vals[..., k][..., None, None]
        dispatch = d_k if dispatch is None else dispatch + d_k
        combine = c_k if combine is None else combine + c_k
    return dispatch, combine, onehot, probs


def router_topk(logits: torch.Tensor, moe: MoEConfig, capacity: int):
    """logits: (..., G, E) -> (dispatch (..., G, E, C), combine (..., G, E, C)
    float32, aux loss).

    Earlier tokens get priority for capacity slots, in token-major,
    choice-minor order (GShard).  A choice past its expert's capacity is
    dropped: its weight for that expert is 0.
    """
    e = logits.shape[-1]
    dispatch, combine, onehot, probs = _route(logits, moe, capacity)
    # Switch-style load-balance aux loss
    lead = tuple(range(onehot.ndim - 2))
    density = onehot.sum(-2).float().mean(dim=lead) / moe.top_k  # fraction per expert
    prob_mass = probs.mean(dim=tuple(range(probs.ndim - 1)))
    aux = e * torch.sum(density * prob_mass)
    return dispatch, combine, aux


def _group_logits(xg: torch.Tensor, router: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Router logits (n, g, E) of (n, g, D) tokens in float32, padded expert
    slots masked."""
    logits = torch.einsum("ngd,de->nge", xg.float(), router.float())
    if moe.e_total > moe.n_experts:  # mask padded expert slots (EP padding)
        pad_mask = torch.arange(moe.e_total, device=xg.device) >= moe.n_experts
        logits = torch.where(pad_mask[None, None, :], -1e9, logits)
    return logits


def _experts(xg, dispatch, combine, w_gate, w_up, w_down) -> torch.Tensor:
    """Dispatch (n, g, d) tokens to capacity slots, run each expert's SwiGLU
    over its slots, and combine: -> (n, g, d)."""
    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(xg.dtype), xg)
    expert_in = constrain(expert_in, None, "experts", None, "d_model")
    gate = torch.einsum("necd,edf->necf", expert_in, w_gate)
    up = torch.einsum("necd,edf->necf", expert_in, w_up)
    hidden = F.silu(gate) * up
    hidden = constrain(hidden, None, "experts", None, "d_expert")
    expert_out = torch.einsum("necf,efd->necd", hidden, w_down)
    return torch.einsum("ngec,necd->ngd", combine.to(xg.dtype), expert_out)


def moe_ffn(x: torch.Tensor, params, moe: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux loss.

    params: router (D, E), w_gate/w_up (E, D, F), w_down (E, F, D).  The
    B·S tokens split into dispatch groups of ``min(group_size, B·S)``; a
    count above ``group_size`` that is not a multiple of it is refused (the
    reference's reshape fails there too).  A DTensor ``x`` takes
    :func:`_sharded_moe_ffn`.
    """
    b, s, d = x.shape
    t = b * s
    g = min(moe.group_size, t)
    if t % g:
        raise ValueError(f"moe_ffn: {t} tokens do not split into dispatch groups of "
                         f"group_size {moe.group_size}")
    capacity = max(1, int(moe.top_k * g / moe.n_experts * moe.capacity_factor))
    if isinstance(x, DTensor):
        return _sharded_moe_ffn(x, params, moe, g, capacity)
    xg = x.reshape(t // g, g, d)
    logits = _group_logits(xg, params["router"], moe)
    dispatch, combine, aux = router_topk(logits, moe, capacity)
    out = _experts(xg, dispatch, combine, params["w_gate"], params["w_up"], params["w_down"])
    return out.reshape(b, s, d), aux


def _local_range(size: int, mesh, placements, dim: int) -> tuple[int, int]:
    """(length, first index) of this rank's shard of a dimension of ``size``
    under ``placements``, split over its mesh axes in mesh order as DTensor
    splits it, from the rank's mesh coordinate alone (no tensor op, so that
    it holds under a fake tensor mode)."""
    first, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            first, size = first + start, min(chunk, size - start)
    return size, first


def _sharded_moe_ffn(x, params, moe: MoEConfig, g: int, capacity: int):
    """:func:`moe_ffn` of DTensors, rank by rank, in two ``local_map`` steps.

    Each rank holds whole batch rows of ``x`` and, of the experts, what the
    rules give it: a slice of the experts over `model` (expert parallelism)
    or a slice of every expert's width (tensor parallelism inside the
    experts), or all of them.

    1. Routing, the same on every rank that holds the same rows.  A rank
       that holds whole dispatch groups routes them from its own tokens; where
       a group spans ranks (a decode batch of one group over the data axis),
       the group's router logits are gathered first, so that every token gets
       the slot, and drops, of the unsplit group.  Out come each token's
       dispatch and combine rows (T, E, C) and the aux loss's sums.
    2. The experts, on each rank's tokens and its share of the experts.  A
       slot holds one token, and an expert maps a zero slot to zero, so a
       rank that fills only its own tokens' slots of a group computes those
       slots exactly.  The output is a partial sum over the axes that split
       the experts or their width, completed where DTensor next needs it.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    b, s, d = x.shape
    e = moe.e_total
    rows = [p if p.is_shard(0) else Replicate() for p in x.placements]
    x = x.redistribute(mesh, rows)
    n_rows, r0 = _local_range(b, mesh, rows, 0)
    tl, r0 = n_rows * s, r0 * s  # this rank's tokens and its first token

    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    router = params["router"].redistribute(mesh, [Replicate()] * mesh.ndim)

    def spread(batch, experts=Replicate(), width=Replicate()):  # placements per mesh axis by its role
        return tuple(batch if p.is_shard(0) else experts if w.is_shard(0) else
                     width if w.is_shard() else Replicate() for p, w in zip(rows, w_gate.placements))

    tok = spread(Shard(0))
    rep = tuple(Replicate() for _ in rows)
    # a tensor that every rank of a batch axis holds whole gets, from each,
    # the gradient of that rank's tokens alone: a partial sum there
    summed = tuple(Partial() if p.is_shard(0) else Replicate() for p in rows)

    def own_grad(w):
        return tuple(Partial() if r.is_shard(0) else p for r, p in zip(rows, w.placements))

    def stats(onehot, probs):  # (1, 2, E): the choices and probabilities, summed over tokens
        return torch.stack([onehot.sum(-2).float().reshape(-1, e).sum(0),
                            probs.reshape(-1, e).sum(0)])[None]

    if tl % g == 0:  # whole groups: route this rank's own
        def route(x_l, router_l):
            dispatch, combine, onehot, probs = _route(
                _group_logits(x_l.reshape(tl // g, g, d), router_l, moe), moe, capacity)
            return dispatch.reshape(tl, e, capacity), combine.reshape(tl, e, capacity), \
                stats(onehot, probs)

        args, in_pl, in_grad = (x, router), (tok, rep), (tok, summed)
    else:  # a group spans ranks: its tokens' logits gathered, the groups this rank touches routed
        n0, n1 = r0 // g, -(-(r0 + tl) // g)

        def route(logits_l):
            mine = slice(r0 - n0 * g, r0 - n0 * g + tl)
            lg = logits_l.reshape(b * s // g, g, e)[n0:n1]
            dispatch, combine, onehot, probs = _route(lg, moe, capacity)
            flat = lambda t: t.reshape(-1, *t.shape[2:])[mine]  # noqa: E731
            return flat(dispatch), flat(combine), stats(flat(onehot), flat(probs))

        logits = local_map(lambda x_l, router_l: _group_logits(x_l, router_l, moe),
                           out_placements=list(tok), in_placements=(tok, rep),
                           in_grad_placements=(tok, summed), device_mesh=mesh)(x, router)
        args, in_pl, in_grad = (logits.redistribute(mesh, rep),), (rep,), (summed,)
    dispatch, combine, sums = local_map(route, out_placements=(tok, tok, tok), in_placements=in_pl,
                                        in_grad_placements=in_grad, device_mesh=mesh)(*args)
    total = finish_partial(sums.sum(0))
    aux = e * torch.sum(total[0] / (b * s * moe.top_k) * (total[1] / (b * s)))

    def experts(x_l, dispatch_l, combine_l, wg, wu, wd):
        off = r0 % g
        pad = (off, -(-(off + tl) // g) * g - off - tl)
        xt, dt, ct = x_l.reshape(tl, d), dispatch_l, combine_l
        if any(pad):  # this rank's tokens in their places in the groups they belong to
            xt, dt, ct = (F.pad(t, (0, 0) * (t.ndim - 1) + pad) for t in (xt, dt, ct))
        grouped = lambda t: t.reshape(-1, g, *t.shape[1:])  # noqa: E731
        out = _experts(grouped(xt), grouped(dt), grouped(ct), wg, wu, wd)
        return out.reshape(-1, d)[off:off + tl].reshape(n_rows, s, d)

    slots = spread(Shard(0), Shard(1))
    partial = spread(Shard(0), Partial(), Partial())
    run = local_map(
        experts, out_placements=list(partial),
        in_placements=(tok, slots, slots, w_gate.placements, w_up.placements, w_down.placements),
        # the experts' share of a token's gradient, and of its combine weights
        # where they split the width, is a partial sum
        in_grad_placements=(partial, slots, spread(Shard(0), Shard(1), Partial()),
                            own_grad(w_gate), own_grad(w_up), own_grad(w_down)),
        device_mesh=mesh)
    out = run(x, dispatch.redistribute(mesh, slots), combine.redistribute(mesh, slots),
              w_gate, w_up, w_down)
    return out, aux
