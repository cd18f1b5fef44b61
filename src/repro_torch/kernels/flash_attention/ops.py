"""Public wrapper: GQA flash attention on the card, or plainly on the CPU.

The transposes and reshapes of the reference's ``ops.flash_attention`` are
part of the contract: q (B, Sq, K, G, d) and k, v (B, Sk, K, d) are
flattened to the kernel's (B*K*G, Sq, d) and (B*K, Sk, d), and the result
comes back as (B, Sq, K, G, d).  A CPU tensor goes to the plain version in
:mod:`.ref`, a CUDA tensor to the hand-written kernel in :mod:`.kernel` (or
the launch raises).  Neither has a backward: the reference kernel has no
VJP.  Each launch of the CUDA kernel is counted in :mod:`..launches` under
``flash_attention``, by the ``instance`` that ran it and by its ``head_dim``.

Tensors that hold no data of their own reach the kernel through an operator
that tracing sees, ``torch.ops.repro_torch.flash_attention``: fake and meta
tensors (the dry run of :mod:`repro_torch.launch.dryrun`) get its output's
shape from ``register_fake``, and a DTensor is split by its sharding rule
into the local tensors each rank computes, which then take the path of a
plain tensor.  Its flop count, 4·d per attended (query, key) pair, is
registered with ``torch.utils.flop_counter``.  A plain CUDA tensor calls the
kernel directly, without the operator's dispatch.  The softmax scale is
1/sqrt(d) unless a caller gives another (Zamba2's (d / 2)^-0.5).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from .. import launches
from .._autograd import forward_only
from .kernel import flash_attention_call, instance_for
from .ref import flash_attention_ref

__all__ = ["attention_pairs", "flash_attention"]


def _attend(qf, kf, vf, groups: int, causal: bool, q_offset: int, scale: float) -> torch.Tensor:
    if type(qf) is not torch.Tensor or qf.device.type == "meta":
        return torch.ops.repro_torch.flash_attention(qf, kf, vf, groups, causal, q_offset, scale)
    if qf.device.type == "cpu":
        return flash_attention_ref(qf, kf, vf, groups=groups, causal=causal, q_offset=q_offset,
                                   scale=scale)
    out = flash_attention_call(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                               groups=groups, causal=causal, q_offset=q_offset, scale=scale)
    d = qf.shape[-1]
    launches.count("flash_attention", instance=instance_for(qf.dtype, d), head_dim=d)
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, groups: int,
                        causal: bool, q_offset: int, scale: float) -> torch.Tensor:
    """(B*K*G, Sq, d), (B*K, Sk, d), (B*K, Sk, d) -> (B*K*G, Sq, d)."""
    return _attend(q, k, v, groups, causal, q_offset, scale)


@_flash_attention_op.register_fake
def _(q, k, v, groups, causal, q_offset, scale):
    return torch.empty_like(q)


def attention_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a row attends, summed over the rows of one head:
    row i sees min(sk, i + q_offset + 1) keys when causal."""
    if not causal:
        return sq * sk
    a = q_offset + 1
    short = min(sq, max(0, sk - a + 1))  # rows that see fewer than sk keys
    return short * a + short * (short - 1) // 2 + (sq - short) * sk


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, groups, causal, q_offset, scale, *args, out_shape=None,
           **kwargs) -> int:
    """4·d operations per attended pair (q·k and p·v, a multiply and an add each)."""
    bh, sq, d = q_shape
    return 4 * d * attention_pairs(sq, k_shape[1], causal, q_offset) * bh


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _sharding(q, k, v, groups, causal, q_offset, scale):
    """Per mesh axis: every tensor replicated, or q, k, v and the output split
    along their first dimension, batch·heads (whole KV groups, as the
    flattening of a batch sharded over that axis gives them)."""
    none = [None, None, None, None]
    return [([Replicate()], [Replicate()] * 3 + none), ([Shard(0)], [Shard(0)] * 3 + none)]


def flash_attention(
    q: torch.Tensor,  # (B, Sq, K, G, d)
    k: torch.Tensor,  # (B, Sk, K, d)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    if q_offset < 0:  # a row could then see no key; the Pallas grid would skip it
        raise ValueError(f"flash_attention takes q_offset >= 0, got {q_offset}")
    b, sq, kh, g, d = q.shape
    sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * kh * g, sq, d)
    kf = k.permute(0, 2, 1, 3).reshape(b * kh, sk, d)
    vf = v.permute(0, 2, 1, 3).reshape(b * kh, sk, d)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = forward_only("flash_attention", _attend, qf, kf, vf, g, causal, q_offset, scale)
    return out.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
