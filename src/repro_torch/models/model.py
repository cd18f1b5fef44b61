"""Model assembly: the train forward and chunked loss of the dense and ssm
families, and prefill and decode_step for serving the dense family.

The counterparts of ``repro.models.model``'s functions of the same names.
The layer stack is a Python loop over ``params["blocks"]``, the counterpart
of ``layer_scan``; ``remat`` wraps each layer of the train forward in
``torch.utils.checkpoint``.  Caches are dicts of tensors as in the
reference, with one difference the port makes to save memory:
:func:`prefill` and :func:`decode_step` write the new keys and values into
the cache tensors they are given, in place, and return the same dict with
``pos`` replaced.  Other families raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import constrain
from .init import ModelParams, init_params, require_family, torch_dtype  # noqa: F401 (re-export)
from .ops import decode_attention, gqa_attention, rms_norm, rope, swiglu
from .ssm import mamba_mixer

__all__ = [
    "AUX_COEF",
    "CACHE_BATCH_AXIS",
    "init_params",
    "embed_inputs",
    "forward_hidden",
    "train_loss",
    "lm_logits",
    "init_cache",
    "prefill",
    "decode_step",
]

AUX_COEF = 0.01


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


def _remat(fn, cfg: ModelConfig):
    """Recompute each layer in the backward pass unless ``remat="none"``.

    ``"full"`` is ``torch.utils.checkpoint`` (non-reentrant) around the layer.
    ``"dots"`` maps to the same: the reference's policy saves the matmul
    outputs, which changes what is kept for the backward pass, not a value."""
    if cfg.remat == "none":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ============================================================ train forward
def embed_inputs(params: ModelParams, cfg: ModelConfig, inputs: torch.Tensor) -> torch.Tensor:
    if inputs.dtype in (torch.int32, torch.int64):
        return params["embed"][inputs]
    return inputs.to(torch_dtype(cfg.dtype))  # precomputed frame/patch embeddings


def forward_hidden(params: ModelParams, cfg: ModelConfig, inputs: torch.Tensor):
    """Full-sequence causal forward -> (hidden (B,S,D), aux loss)."""
    require_family(cfg, "forward_hidden", ("dense", "ssm"))
    h = embed_inputs(params, cfg, inputs)
    h = constrain(h, "batch", "seq", "d_model")
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    if cfg.family == "dense":
        def body(hh, bp):
            hh = hh + _attn(hh, bp, cfg, causal=True, positions=positions)
            f, a = _ffn(hh, bp, cfg)
            # SP: between blocks the residual stream is sequence-sharded on
            # the model axis (a no-op on one card)
            return constrain(hh + f, "batch", "seq_sp", "d_model"), a

        layer = _remat(body, cfg)
        for bp in params["blocks"]:
            h, a = layer(h, bp)
            aux = aux + a
    else:  # ssm
        def body(hh, bp):
            return hh + mamba_mixer(rms_norm(hh, bp["norm_in"], cfg.norm_eps), bp, cfg)

        layer = _remat(body, cfg)
        for bp in params["blocks"]:
            h = layer(h, bp)

    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def lm_logits(params: ModelParams, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden, head)


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, *,
                n_chunks: int = 8, ce_dtype=torch.float32) -> torch.Tensor:
    """Cross-entropy without materialising the full (T, V) logits.

    A fixed, Python-unrolled chunk count keeps the logits of one chunk,
    T/n_chunks x V, at a time in the forward pass; the float32 logsumexp
    and the -1 (ignore) targets are the reference's."""
    b, s, d = hidden.shape
    t = b * s
    hf = hidden.reshape(t, d)
    tf = targets.reshape(t)
    n_chunks = max(1, min(n_chunks, t))
    chunk = (t + n_chunks - 1) // n_chunks
    if chunk * n_chunks != t:
        pad = chunk * n_chunks - t
        hf = F.pad(hf, (0, 0, 0, pad))
        tf = F.pad(tf, (0, pad), value=-1)
    hc = hf.reshape(n_chunks, chunk, d)
    tc = tf.reshape(n_chunks, chunk)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(n_chunks):
        hx, tx = hc[i], tc[i]
        logits = torch.matmul(hx, head).to(ce_dtype)
        lse = torch.logsumexp(logits.float(), dim=-1)
        tgt = torch.gather(logits, -1, torch.clamp(tx, min=0).long()[:, None])[:, 0]
        valid = tx >= 0
        tot = tot + torch.sum(torch.where(valid, lse - tgt, 0.0))
        cnt = cnt + torch.sum(valid)
    return tot / torch.clamp(cnt, min=1)


def train_loss(params: ModelParams, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """batch: tokens + targets (B,S) int (-1 = ignore) -> (loss, {"ce", "aux"})."""
    require_family(cfg, "train_loss", ("dense", "ssm"))
    hidden, aux = forward_hidden(params, cfg, batch["tokens"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    ce = _chunked_ce(hidden, head, batch["targets"], ce_dtype=torch_dtype(cfg.ce_dtype))
    loss = ce + AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux}


# =================================================================== caches
#: the batch axis of each cache entry (``pos`` is per row and host-managed)
CACHE_BATCH_AXIS = {"pos": 0, "k": 1, "v": 1}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None) -> dict[str, Any]:
    """Zeroed KV cache: ``k``/``v`` (L, B, T, K, hd) in the model dtype and
    ``pos`` (B,) int32, on ``device`` (default: the default device)."""
    require_family(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


# ================================================================== prefill
def prefill(params: ModelParams, cfg: ModelConfig, inputs: torch.Tensor, cache: dict):
    """Run the full prompt, fill the cache, return last-token logits.

    inputs: (B, S) token ids.  The cache's rows [0, S) take the prompt's keys
    and values and rows [S, T) are zeroed, in place; ``pos`` becomes S.
    """
    require_family(cfg, "prefill")
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
def decode_step(params: ModelParams, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """One decode step.  token: (B,1) int -> (logits (B,V), the cache).

    ``cache['pos']`` is a PER-ROW (B,) position vector: rows may sit at
    different depths (continuous batching); each row writes its KV at its
    own position, in place, and attends to its own length.  Every position
    must be below the cache length: the reference drops an out-of-range
    write, a torch index raises.
    """
    require_family(cfg, "decode_step")
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
