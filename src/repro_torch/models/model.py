"""Model assembly for serving the dense family: prefill and decode_step.

The counterparts of ``repro.models.model``'s functions of the same names.
The layer stack is a Python loop over ``params["blocks"]``.  Caches are
dicts of tensors as in the reference, with one difference the port makes to
save memory: :func:`prefill` and :func:`decode_step` write the new keys and
values into the cache tensors they are given, in place, and return the same
dict with ``pos`` replaced.  Other families raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import constrain
from .init import DenseParams, init_params, require_dense, torch_dtype  # noqa: F401 (re-export)
from .ops import decode_attention, gqa_attention, rms_norm, rope, swiglu

__all__ = [
    "CACHE_BATCH_AXIS",
    "init_params",
    "embed_inputs",
    "lm_logits",
    "init_cache",
    "prefill",
    "decode_step",
]


# =============================================================== primitives
def _qkv(x, bp, cfg: ModelConfig, prefix: str = "w"):
    q = torch.einsum("bsd,dhk->bshk", x, bp[f"{prefix}q"])
    k = torch.einsum("bsd,dhk->bshk", x, bp[f"{prefix}k"])
    v = torch.einsum("bsd,dhk->bshk", x, bp[f"{prefix}v"])
    if cfg.qkv_bias and prefix == "w":
        q = q + bp["bq"]
        k = k + bp["bk"]
        v = v + bp["bv"]
    return q, k, v


def _attn(h, bp, cfg: ModelConfig, *, causal: bool, positions, kv_positions=None, kv_src=None):
    """Self- (kv_src None) or cross-attention block body."""
    x = rms_norm(h, bp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(x, bp, cfg)
    if kv_src is not None:
        _, k, v = _qkv(kv_src, bp, cfg)
    if causal:  # RoPE only on the causal (decoder) paths
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions if kv_positions is not None else positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "heads", None)
    out = gqa_attention(q, k, v, causal=causal, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                        sm_dtype=torch_dtype(cfg.softmax_dtype))
    return torch.einsum("bshk,hkd->bsd", out, bp["wo"])


def _ffn(h, bp, cfg: ModelConfig):
    """The dense SwiGLU FFN block -> (output, aux loss 0)."""
    x = rms_norm(h, bp["ffn_norm"], cfg.norm_eps)
    return swiglu(x, bp["w_gate"], bp["w_up"], bp["w_down"]), torch.zeros((), device=h.device)


def embed_inputs(params: DenseParams, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    if inputs.dtype in (torch.int32, torch.int64):
        return params["embed"][inputs]
    return inputs.to(torch_dtype(cfg.dtype))  # precomputed frame/patch embeddings


def lm_logits(params: DenseParams, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden, head)


# =================================================================== caches
#: the batch axis of each cache entry (``pos`` is per row and host-managed)
CACHE_BATCH_AXIS = {"pos": 0, "k": 1, "v": 1}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None) -> dict[str, Any]:
    """Zeroed KV cache: ``k``/``v`` (L, B, T, K, hd) in the model dtype and
    ``pos`` (B,) int32, on ``device`` (default: the default device)."""
    require_dense(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


# ================================================================== prefill
def prefill(params: DenseParams, cfg: ModelConfig, inputs: torch.Tensor, cache: dict):
    """Run the full prompt, fill the cache, return last-token logits.

    inputs: (B, S) token ids.  The cache's rows [0, S) take the prompt's keys
    and values and rows [S, T) are zeroed, in place; ``pos`` becomes S.
    """
    require_dense(cfg, "prefill")
    h = embed_inputs(params, cfg, inputs)
    s = h.shape[1]
    cache_len = cache["k"].shape[2]
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    positions = torch.arange(s, device=h.device)
    for i, bp in enumerate(params["blocks"]):
        x = rms_norm(h, bp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(x, bp, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        h = h + torch.einsum("bshk,hkd->bsd", out, bp["wo"])
        f, _ = _ffn(h, bp, cfg)
        h = h + f
        for name, new in (("k", k), ("v", v)):
            cache[name][i, :, :s] = new
            cache[name][i, :, s:] = 0
    cache["pos"] = torch.full((h.shape[0],), s, dtype=torch.int32, device=h.device)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, cfg, h[:, -1:, :])[:, 0]
    return logits, cache


# ==================================================================== decode
def decode_step(params: DenseParams, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """One decode step.  token: (B,1) int -> (logits (B,V), the cache).

    ``cache['pos']`` is a PER-ROW (B,) position vector: rows may sit at
    different depths (continuous batching); each row writes its KV at its
    own position, in place, and attends to its own length.  Every position
    must be below the cache length: the reference drops an out-of-range
    write, a torch index raises.
    """
    require_dense(cfg, "decode_step")
    h = embed_inputs(params, cfg, token)
    pos = cache["pos"].long()  # (B,)
    b_rows = torch.arange(h.shape[0], device=h.device)
    positions = pos[:, None]  # (B,1) for RoPE
    for i, bp in enumerate(params["blocks"]):
        x = rms_norm(h, bp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(x, bp, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        kl, vl = cache["k"][i], cache["v"][i]
        kl[b_rows, pos] = k[:, 0]
        vl[b_rows, pos] = v[:, 0]
        out = decode_attention(q, kl, vl, pos + 1)
        h = h + torch.einsum("bshk,hkd->bsd", out, bp["wo"])
        f, _ = _ffn(h, bp, cfg)
        h = h + f
    cache["pos"] = cache["pos"] + 1
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, cfg, h[:, 0, :])
    return logits, cache
