"""Mixture-of-Experts layer: top-k routing and GShard-style capacity dispatch.

The counterparts of ``repro.models.moe``'s functions of the same names.
Dispatch and combine are one-hot (group, expert, capacity) tensors and the
expert FFN runs as einsums over them, as in the reference: plain products
that the reference computes outside any Pallas kernel.  The per-choice loop
keeps the largest transient at (G, E, C) rather than (G, K, E, C).

Ties between router probabilities may be broken differently by
``torch.topk`` and ``jax.lax.top_k``; float32 router logits of random inputs
have none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..distributed.sharding import constrain

__all__ = ["moe_ffn", "router_topk"]


def router_topk(logits: torch.Tensor, moe: MoEConfig, capacity: int):
    """logits: (..., G, E) -> (dispatch (..., G, E, C), combine (..., G, E, C)
    float32, aux loss).

    Earlier tokens get priority for capacity slots, in token-major,
    choice-minor order (GShard).  A choice past its expert's capacity is
    dropped: its weight for that expert is 0.
    """
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

    # Switch-style load-balance aux loss
    lead = tuple(range(onehot.ndim - 2))
    density = onehot.sum(-2).float().mean(dim=lead) / moe.top_k  # fraction per expert
    prob_mass = probs.mean(dim=tuple(range(probs.ndim - 1)))
    aux = e * torch.sum(density * prob_mass)
    return dispatch, combine, aux


def moe_ffn(x: torch.Tensor, params, moe: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux loss.

    params: router (D, E), w_gate/w_up (E, D, F), w_down (E, F, D).  The
    B·S tokens split into dispatch groups of ``min(group_size, B·S)``; a
    count above ``group_size`` that is not a multiple of it is refused (the
    reference's reshape fails there too).
    """
    b, s, d = x.shape
    t = b * s
    g = min(moe.group_size, t)
    if t % g:
        raise ValueError(f"moe_ffn: {t} tokens do not split into dispatch groups of "
                         f"group_size {moe.group_size}")
    xg = x.reshape(t // g, g, d)

    logits = torch.einsum("ngd,de->nge", xg.float(), params["router"].float())
    if moe.e_total > moe.n_experts:  # mask padded expert slots (EP padding)
        pad_mask = torch.arange(moe.e_total, device=x.device) >= moe.n_experts
        logits = torch.where(pad_mask[None, None, :], -1e9, logits)
    capacity = max(1, int(moe.top_k * g / moe.n_experts * moe.capacity_factor))
    dispatch, combine, aux = router_topk(logits, moe, capacity)

    expert_in = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xg)
    expert_in = constrain(expert_in, None, "experts", None, "d_model")
    gate = torch.einsum("necd,edf->necf", expert_in, params["w_gate"])
    up = torch.einsum("necd,edf->necf", expert_in, params["w_up"])
    hidden = F.silu(gate) * up
    hidden = constrain(hidden, None, "experts", None, "d_expert")
    expert_out = torch.einsum("necf,efd->necd", hidden, params["w_down"])
    out = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), expert_out)
    return out.reshape(b, s, d), aux
