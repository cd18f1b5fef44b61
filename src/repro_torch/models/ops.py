"""Model building blocks: norms, RoPE, attention (naive/chunked/decode), FFN.

Plain functions on tensors, each the counterpart of the function of the same
name in ``repro.models.ops`` with the same cast order: bf16 compute with
float32 softmax and norm accumulations.  ``impl`` selects between the naive
S^2 attention, the chunked online-softmax attention in plain PyTorch, and
the hand-written flash-attention kernel (``"pallas"``, the reference's name
for its kernel path).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..distributed.sharding import constrain, finish_partial, map_shards

__all__ = [
    "rms_norm",
    "rope",
    "swiglu",
    "gqa_attention",
    "decode_attention",
    "causal_mask_bias",
    "length_starts",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast back, then scale in the model dtype."""
    if isinstance(x, DTensor):  # partial sums completed first; a sharded width's sum too
        x = finish_partial(x)
        if any(p.is_shard(x.ndim - 1) for p in x.placements):
            x32 = x.float()
            var = finish_partial(torch.sum(x32 * x32, dim=-1, keepdim=True)) / x.shape[-1]
            return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # a Python-scalar base: a tensor made from one on the card would cost a
    # blocking host-to-device copy in every layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, d), positions: broadcastable to (..., S):
    (S,) at prefill, (B, 1) at decode."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = F.silu(g) * u
    h = constrain(h, "batch", "seq", "d_ff")
    return torch.matmul(h, w_down)


def causal_mask_bias(s_q: int, s_k: int, q_offset: int = 0, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(s_q, s_k) additive bias; query i attends keys j <= i + q_offset."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(kj <= qi, zero, float("-inf")).to(dtype)


def _kv_splits_heads(q: torch.Tensor, n_kv: int) -> bool:
    """Whether ``q`` is a DTensor whose head dim is sharded over a mesh axis
    whose size the KV head count does not divide.  A DTensor shards one
    tensor dimension per mesh axis, so such heads cannot be viewed as (K, G)
    while sharded (XLA shards the two as tiles of the axis)."""
    return isinstance(q, DTensor) and any(
        p.is_shard(2) and n_kv % q.device_mesh.size(i) for i, p in enumerate(q.placements))


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, d) -> (B, S, K, G, d) with H = K*G; heads sharded where K
    cannot follow (:func:`_kv_splits_heads`) are gathered first."""
    b, s, h, d = q.shape
    if _kv_splits_heads(q, n_kv):
        q = q.redistribute(q.device_mesh, [Replicate() if p.is_shard(2) else p for p in q.placements])
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _repeat_kv(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, K, d) -> (B, T, K*G, d): each query head its own copy of its KV head."""
    b, n, kh, d = t.shape
    return t[:, :, :, None, :].expand(b, n, kh, groups, d).reshape(b, n, kh * groups, d)


_HEADS = {"batch": 0, "heads": 2}


def _sharded_attention(q, k, v, **kw) -> torch.Tensor:
    """:func:`gqa_attention` of DTensors, rank by rank (``map_shards``):
    attention is independent per batch row and per head.  Each KV head is
    repeated per query head where the KV heads cannot follow q's head
    sharding (:func:`_kv_splits_heads`)."""
    h, n_kv = q.shape[2], k.shape[2]
    if _kv_splits_heads(q, n_kv):
        k, v = _repeat_kv(k, h // n_kv), _repeat_kv(v, h // n_kv)
    return map_shards(gqa_attention, (q, k, v), (_HEADS,) * 3, _HEADS, **kw)


def _naive_attention(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,K,G,d), k/v: (B,T,K,d) -> (B,S,K,G,d).  fp32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    if causal:
        scores = scores + causal_mask_bias(q.shape[1], k.shape[1], q_offset, device=q.device)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v)


def _chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0, chunk: int = 1024,
                       sm_dtype=torch.float32) -> torch.Tensor:
    """Online softmax over KV chunks in plain PyTorch.

    Never materialises the full (S, T) score matrix: peak scratch is
    (B,K,G,S,chunk).  Chunks wholly above the causal diagonal are skipped by
    the Python loop, as the reference skips them at trace time.
    """
    b, s, kh, g, d = q.shape
    t = k.shape[1]
    nk = (t + chunk - 1) // chunk
    pad = nk * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.reshape(b, nk, chunk, kh, d)
    vc = v.reshape(b, nk, chunk, kh, d)
    qchunk = min(chunk, s)
    nq = (s + qchunk - 1) // qchunk
    qpad = nq * qchunk - s
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, qpad))
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    neg_inf = torch.full((), float("-inf"), dtype=sm_dtype, device=dev)

    out_blocks = []
    for qi in range(nq):
        qb = q[:, qi * qchunk: (qi + 1) * qchunk]
        q_hi = qi * qchunk + qchunk - 1 + q_offset  # last absolute q position
        m = torch.full((b, kh, g, qchunk), float("-inf"), dtype=sm_dtype, device=dev)
        l = torch.zeros((b, kh, g, qchunk), dtype=sm_dtype, device=dev)
        acc = torch.zeros((b, qchunk, kh, g, d), dtype=sm_dtype, device=dev)
        for ci in range(nk):
            if causal and ci * chunk > q_hi:
                continue  # chunk wholly above the causal diagonal
            kb, vb = kc[:, ci], vc[:, ci]
            scores = torch.einsum("bskgd,btkd->bkgst", qb, kb).to(sm_dtype) * scale
            kpos = ci * chunk + torch.arange(chunk, device=dev)
            valid = kpos < t
            diagonal = causal and (ci + 1) * chunk - 1 > qi * qchunk + q_offset
            if diagonal or qpad:
                qpos = qi * qchunk + torch.arange(qchunk, device=dev) + q_offset
                keep = valid[None, :]
                if causal:
                    keep = keep & (kpos[None, :] <= qpos[:, None])
                scores = torch.where(keep, scores, neg_inf)
            elif pad:
                scores = torch.where(valid, scores, neg_inf)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, neg_inf))
            p = torch.exp(scores - m_safe[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgst,btkd->bskgd", p.to(vb.dtype), vb).float()
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        denom = torch.clamp(l, min=1e-37).permute(0, 3, 1, 2)[..., None]
        out_blocks.append((acc / denom).to(q.dtype))
    out = torch.cat(out_blocks, dim=1)
    return out[:, :s] if qpad else out


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int = 0,
    impl: str = "naive",
    chunk: int = 1024,
    sm_dtype=torch.float32,
) -> torch.Tensor:
    """Grouped-query attention.  q: (B,S,H,d), k/v: (B,T,K,d) -> (B,S,H,d)."""
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, q_offset=q_offset, impl=impl, chunk=chunk,
                                  sm_dtype=sm_dtype)
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qg = _split_gqa(q, n_kv)
    if impl == "pallas":
        from ..kernels.flash_attention import ops as fa_ops

        out = fa_ops.flash_attention(qg, k, v, causal=causal, q_offset=q_offset)
    elif impl == "chunked":
        out = _chunked_attention(qg, k, v, causal=causal, q_offset=q_offset, chunk=chunk,
                                 sm_dtype=sm_dtype)
    else:
        out = _naive_attention(qg, k, v, causal=causal, q_offset=q_offset)
    return out.reshape(b, s, h, d)


def length_starts(cache: torch.Tensor) -> torch.Tensor:
    """The first position each rank's shard of a (B, T, K, hd) DTensor cache
    holds: a DTensor sharded like the cache's length (dim 1), one entry a
    shard (an equal split, as ``launch.specs.cache_spec_tree`` makes it)."""
    from torch.distributed.tensor import Shard

    mesh, t = cache.device_mesh, cache.shape[1]
    splits = math.prod(mesh.size(i) for i, p in enumerate(cache.placements) if p.is_shard(1))
    starts = torch.arange(0, t, t // splits, device=cache.device)
    starts = DTensor.from_local(starts, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return starts.redistribute(mesh, [Shard(0) if p.is_shard(1) else Replicate()
                                      for p in cache.placements])


def _decode_part(q, k_cache, v_cache, length, start):
    """One rank's stretch [start, start + T) of a length-split cache: per
    batch row and head, the largest score ``m``, the sum of exponentials
    ``l`` and the unnormalised float32 P·V ``o``, each with a leading dim of
    one for the stretch."""
    b, _, h, d = q.shape
    n_kv, t = k_cache.shape[2], k_cache.shape[1]
    qg = q.reshape(b, 1, n_kv, h // n_kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).float() * (1.0 / math.sqrt(d))
    valid = (start + torch.arange(t, device=q.device))[None, :] < length[:, None]
    scores = scores.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0))
    o = torch.einsum("bkgst,btkd->bskgd", p, v_cache.float())
    return m.reshape(1, b, h), p.sum(-1).reshape(1, b, h), o.reshape(1, b, h, d)


def _split_decode_attention(q, k_cache, v_cache, length) -> torch.Tensor:
    """:func:`decode_attention` of a DTensor cache whose length is split
    over mesh axes (flash-decoding): each rank attends to its own stretch
    (``map_shards``), and the stretches are merged by their log-sum-exp, so
    that only the per-head statistics cross the wire."""
    b, _, h, d = q.shape
    length = torch.as_tensor(length, device=q.device).broadcast_to((b,))
    cache = {"batch": 0, "len": 1, "heads": 2}
    part = {"len": 0, "batch": 1, "heads": 2}
    m, l, o = map_shards(_decode_part, (q, k_cache, v_cache, length, length_starts(k_cache)),
                         ({"batch": 0, "heads": 2}, cache, cache, {"batch": 0}, {"len": 0}),
                         (part, part, part), lead=1)
    top = finish_partial(torch.amax(m, dim=0))
    w = torch.exp(m - top)  # 0 for a stretch wholly past the row's length
    total = finish_partial(torch.sum(l * w, dim=0))
    out = finish_partial(torch.sum(o * w[..., None], dim=0)) / total[..., None]
    return out.to(v_cache.dtype).reshape(b, 1, h, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length) -> torch.Tensor:
    """Single-position attention against a cache.

    q: (B,1,H,d); k/v_cache: (B,T,K,d); length: () or (B,) valid lengths —
    per-row lengths support continuous batching (rows at different depths).
    A DTensor cache whose length is not split runs rank by rank, each rank
    its rows and the cache's heads (``map_shards``); one whose length is
    split over mesh axes takes :func:`_split_decode_attention`.
    """
    if isinstance(k_cache, DTensor):
        if any(p.is_shard(1) for p in k_cache.placements):
            return _split_decode_attention(q, k_cache, v_cache, length)
        heads = {"batch": 0, "heads": 2}
        if isinstance(length, torch.Tensor):
            return map_shards(decode_attention, (q, k_cache, v_cache, length),
                              (heads, heads, heads, {"batch": 0}), heads, lead=1)
        return map_shards(decode_attention, (q, k_cache, v_cache), (heads,) * 3, heads, lead=1,
                          length=length)
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = _split_gqa(q, n_kv)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).float() * scale
    t = k_cache.shape[1]
    length = torch.as_tensor(length, device=q.device).broadcast_to((b,))
    valid = torch.arange(t, device=q.device)[None, None, None, None, :] \
        < length[:, None, None, None, None]
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v_cache)
    return out.reshape(b, 1, h, d)
