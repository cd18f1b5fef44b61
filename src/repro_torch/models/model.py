"""Model assembly: the train forward and chunked loss, prefill and
decode_step of every family (dense / moe / ssm / hybrid / audio enc-dec /
vlm).

The counterparts of ``repro.models.model``'s functions of the same names.
The train forward's layer stacks run through :func:`.scan.layer_scan`, a
Python loop over ``params["blocks"]``, so the hybrid family's shared-block
condition (``maybe_cond``) is a plain int test; ``remat`` wraps each layer of
the train forward in ``torch.utils.checkpoint``.  Prefill and decode loop
over the layers directly.  Caches are dicts of tensors as in the
reference, with one difference the port makes to save memory:
:func:`prefill` and :func:`decode_step` write into the cache tensors they
are given, in place, and return the same dict with ``pos`` replaced.

One fault of the reference is fixed here: its hybrid ``decode_step`` feeds
the shared block the embedding of the *previous* token as ``x0``
(``repro/models/model.py:503``), where the full-sequence forward feeds each
position its own token's embedding; the port's decode feeds the current
token's, so that decode continues the forward.

Under ``attn_impl="pallas"`` the train forward's norms of the ssm and
hybrid layers, of the shared blocks and the final norm of every family go
through the hand-written one-pass norm, which :func:`.ssm.train_ops` chooses;
prefill, decode, the encoder and the attention families' block norms keep
the plain one.

The train forward's embedding, final norm and loss run as named stages
(:func:`repro_torch.obs.stages.stage`), as do the ssm mixer's parts and the
published Zamba2's shared block, so a profiler's trace of scoring puts each
kernel under the stage that launched it.

The published Zamba2 (``cfg.published_hybrid``, ``zamba2-7b-instruct``)
runs its shared blocks as ``transformers``' ``modeling_zamba2.py`` does, not
as the reference's hybrid: at site s, layer ``hybrid_sites[s]``, block s mod
``n_shared_blocks`` takes concat(h, x0), its attention's output goes through
the pre-FF norm (no residual inside the block) into the gated-GELU MLP with
the site's LoRA adapter, then the site's linear; that result is added to
the layer's mixer input only, and the residual stream carries on from h.
Only the train forward runs it: :func:`prefill` and :func:`decode_step`
refuse such a config.  :data:`SHARED_BLOCK_CALLS` counts its blocks' calls.
"""

from __future__ import annotations

import threading
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import constrain, finish_partial, map_shards
from ..obs.stages import stage
from .init import ModelParams, init_params, torch_dtype  # noqa: F401 (re-export)
from .moe import moe_ffn
from .ops import decode_attention, gqa_attention, length_starts, rms_norm, rope, swiglu
from .scan import layer_scan, maybe_cond
from .ssm import init_ssm_state, mamba_decode_step, mamba_mixer, mamba_prefill, train_ops

__all__ = [
    "AUX_COEF",
    "CACHE_BATCH_AXIS",
    "init_params",
    "embed_inputs",
    "encode",
    "forward_hidden",
    "train_loss",
    "lm_logits",
    "init_cache",
    "prefill",
    "decode_step",
    "SHARED_BLOCK_CALLS",
    "reset_shared_block_calls",
]

AUX_COEF = 0.01
#: the families whose layers are attention + FFN blocks
_ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
#: calls of the published Zamba2's shared blocks in the train forward, by block
SHARED_BLOCK_CALLS: dict[int, int] = {}
_calls_mu = threading.Lock()


def reset_shared_block_calls() -> None:
    with _calls_mu:
        SHARED_BLOCK_CALLS.clear()


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


def _cross_kv(cp, enc_out):
    """The cross-attention's keys and values of the encoder output."""
    return (torch.einsum("bsd,dhk->bshk", enc_out, cp["xwk"]),
            torch.einsum("bsd,dhk->bshk", enc_out, cp["xwv"]))


def _cross_attn(h, cp, cfg: ModelConfig, xk, xv):
    """Bidirectional attention of the decoder over the encoder's keys and values."""
    x = rms_norm(h, cp["xattn_norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", x, cp["xwq"])
    out = gqa_attention(q, xk, xv, causal=False, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out, cp["xwo"])


def _ffn(h, bp, cfg: ModelConfig):
    """The FFN block, SwiGLU or mixture of experts -> (output, aux loss)."""
    x = rms_norm(h, bp["ffn_norm"], cfg.norm_eps)
    if cfg.moe.enabled:
        return moe_ffn(x, bp, cfg.moe)
    return swiglu(x, bp["w_gate"], bp["w_up"], bp["w_down"]), torch.zeros((), device=h.device)


def _is_shared_site(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid family's shared block follows layer ``i``."""
    every = cfg.hybrid_attn_every
    return bool(every) and i % every == every - 1


def _shared_qkv(h, x0, sp, cfg: ModelConfig, positions, norm=rms_norm):
    """Zamba2's shared block, its attention's inputs: q, k, v over
    concat(h, x0) (2·d), with RoPE."""
    u = norm(torch.cat([h, x0], dim=-1), sp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(u, sp, cfg)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _shared_out(h, out, sp, cfg: ModelConfig, norm=rms_norm):
    """Zamba2's shared block after its attention: output projection and SwiGLU FFN."""
    h = h + torch.einsum("bshk,hkd->bsd", out, sp["wo"])
    f = swiglu(norm(h, sp["ffn_norm"], cfg.norm_eps), sp["w_gate"], sp["w_up"], sp["w_down"])
    return h + f


def _site_block(h, x0, params, cfg: ModelConfig, site: int, positions, norm) -> torch.Tensor:
    """The published Zamba2's shared block at ``site``, through the site's
    linear, added to h: the mixer's input at the site's layer; ``norm`` is
    the train forward's (:func:`.ssm.train_ops`)."""
    block = site % cfg.n_shared_blocks
    sp, ap = params["shared"][block], params["sites"][site]
    with _calls_mu:
        SHARED_BLOCK_CALLS[block] = SHARED_BLOCK_CALLS.get(block, 0) + 1
    with stage("shared.attn_in"):
        q, k, v = _shared_qkv(h, x0, sp, cfg, positions, norm)
    with stage("shared.attn"):
        out = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                            scale=cfg.attn_scale or None)
    with stage("shared.attn_out"):
        t = norm(torch.einsum("bshk,hkd->bsd", out, sp["wo"]), sp["ffn_norm"], cfg.norm_eps)
    with stage("shared.mlp"):
        a = torch.matmul(t, ap["lora_in"])
        g = torch.matmul(t, sp["w_gate"]) + torch.matmul(a, ap["lora_gate"])
        u = torch.matmul(t, sp["w_up"]) + torch.matmul(a, ap["lora_up"])
        act = F.gelu if cfg.ffn_act == "gelu" else F.silu  # exact erf GELU, as published
        f = torch.matmul(act(g) * u, sp["w_down"])
    with stage("shared.linear"):
        return h + torch.matmul(f, ap["linear"])


def _refuse_published_hybrid(cfg: ModelConfig, what: str) -> None:
    """Prefill and decode run the reference's hybrid only: refuse the published
    Zamba2's options rather than answer wrongly."""
    options = [name for name, on in (
        ("hybrid_sites", cfg.published_hybrid), ("n_shared_blocks", cfg.n_shared_blocks != 1),
        ("adapter_rank", cfg.adapter_rank), ("ffn_act", cfg.ffn_act != "silu"),
        ("attn_scale", cfg.attn_scale), ("ssm.ngroups", cfg.ssm.ngroups != 1)) if on]
    if options:
        raise ValueError(f"{what} does not run {cfg.name}'s options {options}; only the train "
                         "forward (forward_hidden, train_loss) does")


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
        if isinstance(params["embed"], DTensor):  # DTensor's rules for an index vary by version
            return F.embedding(inputs, params["embed"])
        return params["embed"][inputs]
    return inputs.to(torch_dtype(cfg.dtype))  # precomputed frame/patch embeddings


def encode(params: ModelParams, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings: bidirectional
    attention, no RoPE."""
    h = frames.to(torch_dtype(cfg.dtype))
    positions = torch.arange(h.shape[1], device=h.device)

    def body(hh, bp):
        hh = hh + _attn(hh, bp, cfg, causal=False, positions=positions)
        f, _ = _ffn(hh, bp, cfg)
        return hh + f, None

    h, _ = layer_scan(_remat(body, cfg), h, params["enc_blocks"], unroll=not cfg.scan_layers)
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def forward_hidden(params: ModelParams, cfg: ModelConfig, inputs: torch.Tensor, *,
                   enc_out: torch.Tensor | None = None):
    """Full-sequence causal forward -> (hidden (B,S,D), aux loss)."""
    with stage("model.embed"):
        h = embed_inputs(params, cfg, inputs)
    h = constrain(h, "batch", "seq", "d_model")
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    unroll = not cfg.scan_layers
    norm = train_ops(cfg).norm

    if cfg.family in ("dense", "moe", "vlm"):
        def body(carry, bp):
            hh, aux = carry
            hh = hh + _attn(hh, bp, cfg, causal=True, positions=positions)
            hh = constrain(hh, "batch", "seq", "d_model")  # the attention's partial sums
            f, a = _ffn(hh, bp, cfg)
            # SP: between blocks the residual stream is sequence-sharded on
            # the model axis (a no-op on one card)
            return (constrain(hh + f, "batch", "seq_sp", "d_model"), aux + a), None

        (h, aux), _ = layer_scan(_remat(body, cfg), (h, aux), params["blocks"], unroll=unroll)
    elif cfg.family == "audio":
        if enc_out is None:
            raise ValueError("the audio family needs the encoder output, enc_out")

        def body(hh, xs):
            bp, cp = xs
            hh = hh + _attn(hh, bp, cfg, causal=True, positions=positions)
            hh = hh + _cross_attn(hh, cp, cfg, *_cross_kv(cp, enc_out))
            f, _ = _ffn(hh, bp, cfg)
            return hh + f, None

        h, _ = layer_scan(_remat(body, cfg), h, (params["blocks"], params["cross"]), unroll=unroll)
    elif cfg.published_hybrid:
        x0 = h
        site_of = {layer: s for s, layer in enumerate(cfg.hybrid_sites)}

        def body(hh, xs):
            bp, i = xs
            m = maybe_cond(i in site_of, lambda v: _site_block(v, x0, params, cfg, site_of[i], positions, norm),
                           lambda v: v, hh)
            with stage("ssm.norm_in"):
                x = norm(m, bp["norm_in"], cfg.norm_eps)
            return constrain(hh + mamba_mixer(x, bp, cfg), "batch", "seq_sp", "d_model"), None

        h, _ = layer_scan(_remat(body, cfg), h, (params["blocks"], list(range(cfg.n_layers))),
                          unroll=unroll)
    elif cfg.family in ("ssm", "hybrid"):
        x0 = h

        def shared_block(hh):
            sp = params["shared"]
            q, k, v = _shared_qkv(hh, x0, sp, cfg, positions, norm)
            out = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
            return constrain(_shared_out(hh, out, sp, cfg, norm), "batch", "seq_sp", "d_model")

        def body(hh, xs):
            bp, i = xs
            with stage("ssm.norm_in"):
                x = norm(hh, bp["norm_in"], cfg.norm_eps)
            hh = hh + mamba_mixer(x, bp, cfg)
            hh = constrain(hh, "batch", "seq_sp", "d_model")
            return maybe_cond(_is_shared_site(cfg, i), shared_block, lambda v: v, hh), None

        h, _ = layer_scan(_remat(body, cfg), h, (params["blocks"], list(range(cfg.n_layers))),
                          unroll=unroll)
    else:
        raise ValueError(f"unknown family {cfg.family}")

    with stage("model.final_norm"):
        return norm(h, params["final_norm"], cfg.norm_eps), aux


def lm_logits(params: ModelParams, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden, head)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)`` of (B, S, V) DTensor logits, written out as
    PyTorch computes it (max shift, an infinite max taken as 0), so that
    vocab-sharded logits reduce their shards where DTensor would gather the
    whole row.  The shift is a constant of the gradient, the softmax."""
    m = torch.amax(x.detach(), dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)
    e = constrain(torch.exp(x - m), "batch", "seq", "vocab")  # its gradient stays sharded too
    return torch.log(finish_partial(torch.sum(e, dim=-1))) + m[..., 0]


def _sharded_ce(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, *,
                n_chunks: int = 8, ce_dtype=torch.float32) -> torch.Tensor:
    """:func:`_chunked_ce` of a DTensor ``hidden``, in the reduction's
    sharding-friendly form.  It chunks the sequence, every row at once, where
    :func:`_chunked_ce` chunks the flattened tokens (a DTensor cannot split
    a sharded dimension in two): the chunks hold as many tokens, and only
    the order of the float32 sums differs.  The target's logit is selected
    by a mask where :func:`_chunked_ce` gathers it (the same value, and a
    gradient that keeps vocab-sharded logits sharded: DTensor's gather
    backward fills a replicated zeros tensor of the logits' global shape),
    and the logsumexp is :func:`_logsumexp`."""
    s = hidden.shape[1]
    n_chunks = max(1, min(n_chunks, s))
    chunk = (s + n_chunks - 1) // n_chunks
    if chunk * n_chunks != s:
        pad = chunk * n_chunks - s
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(n_chunks):
        hx, tx = hidden[:, i * chunk:(i + 1) * chunk], targets[:, i * chunk:(i + 1) * chunk]
        logits = torch.matmul(hx, head).to(ce_dtype)
        lse = _logsumexp(logits.float())
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        hit = constrain(vocab == tx[..., None], "batch", "seq", "vocab")
        tgt = finish_partial(constrain(torch.where(hit, logits, 0.0), "batch", "seq", "vocab").sum(-1))
        valid = tx >= 0
        tot = tot + torch.sum(torch.where(valid, lse - tgt, 0.0))
        cnt = cnt + torch.sum(valid)
    return tot / torch.clamp(cnt, min=1)


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, *,
                n_chunks: int = 8, ce_dtype=torch.float32) -> torch.Tensor:
    """Cross-entropy without materialising the full (T, V) logits.

    A fixed, Python-unrolled chunk count keeps the logits of one chunk,
    T/n_chunks x V, at a time in the forward pass; the float32 logsumexp
    and the -1 (ignore) targets are the reference's.  A DTensor takes
    :func:`_sharded_ce`."""
    if isinstance(hidden, DTensor):
        return _sharded_ce(hidden, head, targets, n_chunks=n_chunks, ce_dtype=ce_dtype)
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
    """batch: tokens (or ``embeds`` of the vlm family, plus ``frames`` of the
    audio family) and targets (B,S) int (-1 = ignore) -> (loss, {"ce", "aux"})."""
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch["frames"])
        inputs = batch["tokens"]
    elif cfg.input_kind == "patches":
        inputs = batch["embeds"]
    else:
        inputs = batch["tokens"]
    hidden, aux = forward_hidden(params, cfg, inputs, enc_out=enc_out)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    with stage("model.head_ce"):
        ce = _chunked_ce(hidden, head, batch["targets"], ce_dtype=torch_dtype(cfg.ce_dtype))
    loss = ce + AUX_COEF * aux
    return loss, {"ce": ce, "aux": aux}


# =================================================================== caches
#: the batch axis of each cache entry (``pos`` is per row and host-managed)
CACHE_BATCH_AXIS = {"pos": 0, "k": 1, "v": 1, "conv": 1, "ssm": 1, "shared_k": 1, "shared_v": 1,
                    "x0": 0, "xk": 1, "xv": 1}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, enc_len: int = 0,
               device=None) -> dict[str, Any]:
    """Zeroed cache on ``device`` (default: the default device), the
    reference's entries: ``pos`` (B,) int32; ``k``/``v`` (L, B, T, K, hd) of
    the attention families; ``xk``/``xv`` (L, B, enc_len, K, hd) of the audio
    family; ``conv`` and float32 ``ssm`` (L, B, ...) of the ssm and hybrid
    families; and the hybrid's ``shared_k``/``shared_v`` (sites, B, T, K, hd)
    and ``x0`` (B, 1, D)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    hd, L = cfg.resolved_head_dim, cfg.n_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache: dict[str, Any] = {"pos": zeros(batch, dt=torch.int32)}
    if cfg.family in _ATTN_FAMILIES:
        cache["k"] = zeros(L, batch, cache_len, cfg.n_kv_heads, hd)
        cache["v"] = zeros(L, batch, cache_len, cfg.n_kv_heads, hd)
    if cfg.family == "audio":
        cache["xk"] = zeros(L, batch, enc_len, cfg.n_kv_heads, hd)
        cache["xv"] = zeros(L, batch, enc_len, cfg.n_kv_heads, hd)
    if cfg.family in ("ssm", "hybrid"):
        st = init_ssm_state(cfg, batch, dtype, dev)
        cache["conv"] = zeros(L, *st["conv"].shape)
        cache["ssm"] = zeros(L, *st["ssm"].shape, dt=torch.float32)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        n_sites = cfg.n_layers // cfg.hybrid_attn_every
        cache["shared_k"] = zeros(n_sites, batch, cache_len, cfg.n_kv_heads, hd)
        cache["shared_v"] = zeros(n_sites, batch, cache_len, cfg.n_kv_heads, hd)
        cache["x0"] = zeros(batch, 1, cfg.d_model)  # embedding of the last token
    return cache


def _write_kv(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """A prompt's keys and values into rows [0, S) of one layer's (B, T, K, hd)
    cache; rows [S, T) are zeroed, as the reference pads them."""
    s = k.shape[1]
    for cached, new in ((kc, k), (vc, v)):
        cached[:, :s] = new
        if s < cached.shape[1]:
            cached[:, s:].zero_()


# ================================================================== prefill
def prefill(params: ModelParams, cfg: ModelConfig, inputs: torch.Tensor, cache: dict, *,
            enc_frames: torch.Tensor | None = None):
    """Run the full prompt, fill the cache, return last-token logits.

    inputs: (B, S) token ids (or (B, S, D) patch embeddings).  The cache's
    rows [0, S) take the prompt's keys and values and rows [S, T) are
    zeroed, in place; ``pos`` becomes S.  The audio family encodes
    ``enc_frames`` (B, enc_len, D) first, into a cache made with that
    ``enc_len``.  The published Zamba2's options are refused.
    """
    _refuse_published_hybrid(cfg, "prefill")
    h = constrain(embed_inputs(params, cfg, inputs), "batch", "seq", "d_model")
    s = h.shape[1]
    for name in ("k", "shared_k"):
        if name in cache and s > cache[name].shape[2]:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache[name].shape[2]}")
    positions = torch.arange(s, device=h.device)

    enc_out = None
    if cfg.is_encoder_decoder:
        if enc_frames is None:
            raise ValueError("the audio family's prefill needs enc_frames")
        if enc_frames.shape[1] != cache["xk"].shape[2]:
            raise ValueError(f"{enc_frames.shape[1]} encoder frames do not fit a cache made "
                             f"with enc_len {cache['xk'].shape[2]}")
        enc_out = encode(params, cfg, enc_frames)

    if cfg.family in _ATTN_FAMILIES:
        cross = params["cross"] if cfg.family == "audio" else [None] * cfg.n_layers
        for i, (bp, cp) in enumerate(zip(params["blocks"], cross)):
            x = rms_norm(h, bp["attn_norm"], cfg.norm_eps)
            q, k, v = _qkv(x, bp, cfg)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            out = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
            h = h + torch.einsum("bshk,hkd->bsd", out, bp["wo"])
            h = constrain(h, "batch", "seq", "d_model")
            _write_kv(cache["k"][i], cache["v"][i], k, v)
            if cp is not None:
                xk, xv = _cross_kv(cp, enc_out)
                h = h + _cross_attn(h, cp, cfg, xk, xv)
                cache["xk"][i] = xk
                cache["xv"][i] = xv
            f, _ = _ffn(h, bp, cfg)
            h = h + f
            h = constrain(h, "batch", "seq", "d_model")
    elif cfg.family in ("ssm", "hybrid"):
        x0 = h
        for i, bp in enumerate(params["blocks"]):
            y, conv, ssm = mamba_prefill(rms_norm(h, bp["norm_in"], cfg.norm_eps), bp, cfg)
            h = h + y
            h = constrain(h, "batch", "seq", "d_model")
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
            if _is_shared_site(cfg, i):
                sp, site = params["shared"], i // cfg.hybrid_attn_every
                q, k, v = _shared_qkv(h, x0, sp, cfg, positions)
                out = gqa_attention(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
                h = constrain(_shared_out(h, out, sp, cfg), "batch", "seq", "d_model")
                _write_kv(cache["shared_k"][site], cache["shared_v"][site], k, v)
        if "x0" in cache:
            cache["x0"][:] = x0[:, -1:]
    else:
        raise ValueError(f"unknown family {cfg.family}")

    cache["pos"] = torch.full((h.shape[0],), s, dtype=torch.int32, device=h.device)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, cfg, h[:, -1:, :])[:, 0]
    return logits, cache


# ==================================================================== decode
def _write_at(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
              start: torch.Tensor) -> torch.Tensor:
    """Each row's entry at its position, into one rank's shard of a (B, T, K,
    hd) cache that holds positions [start, start + T): a row whose position
    lies elsewhere keeps its entries."""
    t = cache.shape[1]
    here = pos - start
    idx = here.clamp(0, t - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    mine = ((here >= 0) & (here < t))[:, None, None]
    cache[rows, idx] = torch.where(mine, new, cache[rows, idx])
    return cache


def _write_sharded(cache, new, pos) -> None:
    """``cache[rows, pos] = new`` for a DTensor cache whose batch, length
    and heads may be sharded (the flash-decoding split of the length,
    ``launch.specs.cache_spec_tree``): each rank writes the rows whose
    positions its shard holds.  DTensor has no in-place sharding rule for
    the indexed write."""
    roles = {"batch": 0, "len": 1, "heads": 2}
    map_shards(_write_at, (cache, new, pos, length_starts(cache)),
               (roles, {"batch": 0, "heads": 1}, {"batch": 0}, {"len": 0}), roles)


def decode_step(params: ModelParams, cfg: ModelConfig, token: torch.Tensor, cache: dict):
    """One decode step.  token: (B,1) int -> (logits (B,V), the cache).

    ``cache['pos']`` is a PER-ROW (B,) position vector: rows may sit at
    different depths (continuous batching); each row writes its KV at its
    own position, in place, and attends to its own length.  Every position
    must be below the cache length: the reference drops an out-of-range
    write, a torch index raises.  The ssm and hybrid families' recurrent
    state is replaced in place.  The published Zamba2's options are refused.
    """
    _refuse_published_hybrid(cfg, "decode_step")
    h = constrain(embed_inputs(params, cfg, token), "batch", "seq", "d_model")
    pos = cache["pos"].long()  # (B,)
    b_rows = torch.arange(h.shape[0], device=h.device)
    positions = pos[:, None]  # (B,1) for RoPE

    def attend(q, k, v, kl, vl):
        """Write this step's k, v at each row's position and attend the row's length."""
        if isinstance(kl, DTensor):
            _write_sharded(kl, k[:, 0], pos)
            _write_sharded(vl, v[:, 0], pos)
        else:
            kl[b_rows, pos] = k[:, 0]
            vl[b_rows, pos] = v[:, 0]
        return decode_attention(q, kl, vl, pos + 1)

    if cfg.family in _ATTN_FAMILIES:
        cross = params["cross"] if cfg.family == "audio" else [None] * cfg.n_layers
        for i, (bp, cp) in enumerate(zip(params["blocks"], cross)):
            x = rms_norm(h, bp["attn_norm"], cfg.norm_eps)
            q, k, v = _qkv(x, bp, cfg)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            out = attend(q, k, v, cache["k"][i], cache["v"][i])
            h = h + torch.einsum("bshk,hkd->bsd", out, bp["wo"])
            h = constrain(h, "batch", "seq", "d_model")
            if cp is not None:  # against the encoder's keys and values of the prefill
                xq = torch.einsum("bsd,dhk->bshk", rms_norm(h, cp["xattn_norm"], cfg.norm_eps),
                                  cp["xwq"])
                xk, xv = cache["xk"][i], cache["xv"][i]
                xout = decode_attention(xq, xk, xv, xk.shape[1])
                h = h + torch.einsum("bshk,hkd->bsd", xout, cp["xwo"])
            f, _ = _ffn(h, bp, cfg)
            h = h + f
            h = constrain(h, "batch", "seq", "d_model")
    elif cfg.family in ("ssm", "hybrid"):
        x0 = h  # this token's embedding, as the forward feeds each position its own
        for i, bp in enumerate(params["blocks"]):
            state = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
            y, st = mamba_decode_step(rms_norm(h, bp["norm_in"], cfg.norm_eps), state, bp, cfg)
            h = h + y
            h = constrain(h, "batch", "seq", "d_model")
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
            if _is_shared_site(cfg, i):
                sp, site = params["shared"], i // cfg.hybrid_attn_every
                q, k, v = _shared_qkv(h, x0, sp, cfg, positions)
                out = attend(q, k, v, cache["shared_k"][site], cache["shared_v"][site])
                h = constrain(_shared_out(h, out, sp, cfg), "batch", "seq", "d_model")
        if "x0" in cache:
            cache["x0"][:] = x0
    else:
        raise ValueError(f"unknown family {cfg.family}")

    cache["pos"] = cache["pos"] + 1
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, cfg, h[:, 0, :])
    return logits, cache
