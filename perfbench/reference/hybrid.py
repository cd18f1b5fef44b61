"""Plain float32 reference of Zamba2 (the ``hybrid`` family).

Written from the published description (Zyphra's Zamba2 report,
arXiv:2411.15242, and the layer equations of transformers'
``modeling_zamba2.py``) and the configuration's published names, not from
the program.  It imports nothing of the program: the benchmark makes the
weights, hands the same values to both sides, and this module works
everything else out again.  The Mamba2 layer's SSD scan and causal
convolution, and the float8 control's helpers, are those of
:mod:`perfbench.reference.ssm`.

The model, with x0 the token embeddings and h = x0::

    for layer l:
        m = h
        if l is hybrid_layer_ids[s]:                  # block b = s mod num_mem_blocks
            u = RMSNorm_b,in(concat(h, x0))           # attention_hidden_size wide
            q, k, v = u Wq_b, u Wk_b, u Wv_b          # heads of attention_head_dim
            q, k = rope(q), rope(k)                   # over all of the head dim
            a = softmax(q k^T (head_dim / 2)^-0.5, causal) v
            t = RMSNorm_b,ff(a Wo_b)                  # no residual inside the block
            g, up = t Wgate_b + (t A_s) Bgate_s, t Wup_b + (t A_s) Bup_s
            m = h + ((gelu(g) * up) Wdown_b) L_s      # into the mixer's input only
        h = h + Mamba2_l(RMSNorm_l(m))
    logits = RMSNorm_f(h) embed^T

Mamba2_l is the Mamba2 layer with ``mamba_ngroups`` groups of B and C (the
heads of group g read its B and C) and its gated RMSNorm taken over groups of
d_inner / ngroups channels (Zamba2RMSNormGated).

Parameters are a tree ``{"embed", "blocks": [per-layer dict], "final_norm",
"shared": [per-block dict], "sites": [per-site dict]}``, named as the
benchmark's weight maker names them; the published names they stand for:
each layer's ``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt`` are the slices of
``in_proj`` ([z | x | B | C | dt]), ``conv_*`` of ``conv1d`` and its bias,
``norm`` the gated norm's weight, ``norm_in`` the layer's input_layernorm;
a shared block's ``attn_norm``, ``wq``/``wk``/``wv``/``wo`` and ``ffn_norm``
are its input_layernorm, q/k/v/o_proj and pre_ff_layernorm, ``w_gate`` and
``w_up`` the halves of its MLP's gate_up_proj, ``w_down`` its down_proj; a
site's ``lora_in`` is the first matrix of its gate_up_proj adapter,
``lora_gate`` and ``lora_up`` the halves of its second, ``linear`` the
hybrid layer's linear.  The LM head is tied to the embedding.  Every
computation runs in float32 with TF32 off.  ``quant="fp8"`` is the control:
the model computed in float8 e4m3 (one scale per tensor) wherever the
configuration's dtype, bf16, holds a tensor, with float32 sums; dt, A and D
stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.ssm import _causal_conv, _mm, _q, exact_float32, ssd

QUERY_BLOCK = 512  # query rows of attention at a time, so that 4096 tokens fit


def dims(cfg: dict) -> dict:
    """The sizes the reference needs, by the published names."""
    dm = cfg["hidden_size"]
    m = cfg["pad_vocab_size_multiple"]
    return {"d_model": dm, "d_inner": cfg["mamba_expand"] * dm, "heads": cfg["n_mamba_heads"],
            "headdim": cfg["mamba_headdim"], "groups": cfg["mamba_ngroups"], "d_state": cfg["mamba_d_state"],
            "d_conv": cfg["mamba_d_conv"], "chunk": cfg["chunk_size"], "layers": cfg["num_hidden_layers"],
            "attn_width": cfg["attention_hidden_size"], "attn_heads": cfg["num_attention_heads"],
            "kv_heads": cfg["num_key_value_heads"], "head_dim": cfg["attention_head_dim"],
            "ffn": cfg["ffn_hidden_size"], "rank": cfg["adapter_rank"], "blocks": cfg["num_mem_blocks"],
            "sites": list(cfg["hybrid_layer_ids"]), "vocab": (cfg["vocab_size"] + m - 1) // m * m}


def param_shapes(cfg: dict) -> dict:
    """Every parameter as (shape, how it is drawn, the draw's argument), in
    the tree's layout.  The draws follow the mamba2-370m configuration's
    (mamba_ssm's ``Mamba2`` and ``_init_weights``, normal where it draws
    uniformly): projections std 1/sqrt(3 fan_in); the mixer's out_proj, the
    attention's o, the MLP's down and each site's linear that much over
    sqrt(layers); the embedding 0.02; dt's bias the inverse softplus of a
    log-uniform dt in [time_step_min, time_step_max] floored at
    time_step_floor; A in [1, 16]; D and norms 1.  Both adapter matrices are
    normal and non-zero, so that a program that leaves one out is seen."""
    d = dims(cfg)
    dm, di, h, k, n_layer = d["d_model"], d["d_inner"], d["heads"], d["d_conv"], d["layers"]
    gn, aw, f, r = d["groups"] * d["d_state"], d["attn_width"], d["ffn"], d["rank"]
    hq, hk, hd = d["attn_heads"], d["kv_heads"], d["head_dim"]

    def std(fan_in: int, out: bool = False) -> float:
        return (3 * fan_in * (n_layer if out else 1)) ** -0.5

    dt = (cfg["time_step_min"], cfg["time_step_max"], cfg["time_step_floor"])
    layer = {
        "norm_in": ((dm,), "ones", None), "w_z": ((dm, di), "normal", std(dm)),
        "w_x": ((dm, di), "normal", std(dm)), "w_B": ((dm, gn), "normal", std(dm)),
        "w_C": ((dm, gn), "normal", std(dm)), "w_dt": ((dm, h), "normal", std(dm)),
        "dt_bias": ((h,), "dt_bias", dt), "conv_x": ((k, di), "normal", std(k)),
        "conv_x_b": ((di,), "uniform", k ** -0.5), "conv_B": ((k, gn), "normal", std(k)),
        "conv_B_b": ((gn,), "uniform", k ** -0.5), "conv_C": ((k, gn), "normal", std(k)),
        "conv_C_b": ((gn,), "uniform", k ** -0.5), "A_log": ((h,), "a_log", (1, 16)),
        "D_skip": ((h,), "ones32", None), "norm": ((di,), "ones", None),
        "out_proj": ((di, dm), "normal", std(di, out=True)),
    }
    block = {
        "attn_norm": ((aw,), "ones", None), "wq": ((aw, hq, hd), "normal", std(aw)),
        "wk": ((aw, hk, hd), "normal", std(aw)), "wv": ((aw, hk, hd), "normal", std(aw)),
        "wo": ((hq, hd, dm), "normal", std(hq * hd, out=True)), "ffn_norm": ((dm,), "ones", None),
        "w_gate": ((dm, f), "normal", std(dm)), "w_up": ((dm, f), "normal", std(dm)),
        "w_down": ((f, dm), "normal", std(f, out=True)),
    }
    site = {"lora_in": ((dm, r), "normal", std(dm)), "lora_gate": ((r, f), "normal", std(r)),
            "lora_up": ((r, f), "normal", std(r)), "linear": ((dm, dm), "normal", std(dm, out=True))}
    return {"embed": ((d["vocab"], dm), "normal", 0.02), "blocks": [dict(layer) for _ in range(n_layer)],
            "final_norm": ((dm,), "ones", None), "shared": [dict(block) for _ in range(d["blocks"])],
            "sites": [dict(site) for _ in d["sites"]]}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Zamba2RMSNorm: x / sqrt(mean(x^2) + eps), times the weight."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """Zamba2RMSNormGated: y * silu(z), normalised over each group of
    d_inner / groups channels, times the weight."""
    g = y * F.silu(z)
    *lead, di = g.shape
    g = g.reshape(*lead, groups, di // groups)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps)
    return g.reshape(*lead, di) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head dim, x (B, S, H, d) at positions
    0..S-1: x cos + rotate_half(x) sin, rotate_half(x) = (-x2, x1)."""
    s, d = x.shape[1], x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[:, None, :], emb.sin()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def softmax_scale(cfg: dict) -> float:
    """Zamba2Attention's scaling, (attention_head_dim / 2)^-0.5."""
    return (cfg["attention_head_dim"] / 2) ** -0.5


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention, q (B, S, H, d) and k, v (B, S, K, d), each
    KV head shared by H / K query heads; QUERY_BLOCK query rows at a time."""
    s, h = q.shape[1], q.shape[2]
    rep = h // k.shape[2]
    kh, vh = (t.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3) for t in (k, v))  # (B, H, S, d)
    out = []
    for i in range(0, s, QUERY_BLOCK):
        qb = q[:, i:i + QUERY_BLOCK].permute(0, 2, 1, 3)
        scores = qb @ kh.transpose(-1, -2) * scale
        rows = torch.arange(i, i + qb.shape[2], device=q.device)[:, None]
        scores = scores.masked_fill(torch.arange(s, device=q.device)[None, :] > rows, -math.inf)
        out.append((torch.softmax(scores, dim=-1) @ vh).permute(0, 2, 1, 3))
    return torch.cat(out, dim=1)


def shared_block(h, x0, w: dict, site: dict, cfg: dict, quant: str | None) -> torch.Tensor:
    """The shared block at one site, through the site's adapter and linear:
    what is added to the site's mixer input."""
    b, s, _ = h.shape
    eps = cfg["rms_norm_eps"]
    hq, hk, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["attention_head_dim"]
    u = _q(rms_norm(torch.cat([h, x0], dim=-1), _q(w["attn_norm"], quant), eps), quant)
    q = _mm(u, w["wq"].reshape(u.shape[-1], -1), quant).reshape(b, s, hq, hd)
    k = _mm(u, w["wk"].reshape(u.shape[-1], -1), quant).reshape(b, s, hk, hd)
    v = _mm(u, w["wv"].reshape(u.shape[-1], -1), quant).reshape(b, s, hk, hd)
    q, k = _q(rope(q, cfg["rope_theta"]), quant), _q(rope(k, cfg["rope_theta"]), quant)
    a = _q(attention(q, k, v, softmax_scale(cfg)), quant).reshape(b, s, hq * hd)
    t = _q(rms_norm(_mm(a, w["wo"].reshape(hq * hd, -1), quant), _q(w["ffn_norm"], quant), eps), quant)
    lora = _mm(t, site["lora_in"], quant)
    g = _q(_mm(t, w["w_gate"], quant) + _mm(lora, site["lora_gate"], quant), quant)
    up = _q(_mm(t, w["w_up"], quant) + _mm(lora, site["lora_up"], quant), quant)
    f = _mm(_q(F.gelu(g) * up, quant), w["w_down"], quant)
    return _mm(f, site["linear"], quant)


def mixer(u: torch.Tensor, w: dict, cfg: dict, quant: str | None) -> torch.Tensor:
    """One Mamba2 layer's mixer on its normed input u (B, S, D)."""
    bs, s, _ = u.shape
    g, h, p = cfg["mamba_ngroups"], cfg["n_mamba_heads"], cfg["mamba_headdim"]
    z = _mm(u, w["w_z"], quant)

    def conv(name):
        return _q(_causal_conv(_mm(u, w[f"w_{name}"], quant), _q(w[f"conv_{name}"], quant),
                               _q(w[f"conv_{name}_b"], quant)), quant)
    x, b, c = conv("x"), conv("B"), conv("C")
    dt = F.softplus(_mm(u, w["w_dt"], quant) + _q(w["dt_bias"], quant))  # time_step_limit: none
    y = ssd(x.reshape(bs, s, h, p), dt, -torch.exp(w["A_log"]), b.reshape(bs, s, g, -1),
            c.reshape(bs, s, g, -1), w["D_skip"], cfg["chunk_size"], g)
    y = _q(y, quant).reshape(bs, s, -1)
    y = _q(gated_rms_norm(_q(y, quant), _q(z, quant), _q(w["norm"], quant), g, cfg["rms_norm_eps"]), quant)
    return _mm(y, w["out_proj"], quant)


def hidden(weights: dict, cfg: dict, tokens: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    """The final-normed hidden states of rows ``tokens`` (B, S)."""
    eps = cfg["rms_norm_eps"]
    x0 = _q(weights["embed"], quant)[tokens.long()]
    h = x0
    site_of = {layer: s for s, layer in enumerate(cfg["hybrid_layer_ids"])}
    for layer, w in enumerate(weights["blocks"]):
        m = h
        if layer in site_of:
            s = site_of[layer]
            block = weights["shared"][s % cfg["num_mem_blocks"]]
            m = _q(h + shared_block(h, x0, block, weights["sites"][s], cfg, quant), quant)
        h = _q(h + mixer(_q(rms_norm(m, _q(w["norm_in"], quant), eps), quant), w, cfg, quant), quant)
    return _q(rms_norm(h, _q(weights["final_norm"], quant), eps), quant)


def token_losses_sum(weights: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor, *,
                     quant: str | None = None, head_rows: int = 2048) -> tuple[torch.Tensor, int]:
    """Sum over the valid (>= 0) targets of -log softmax(logits)[target], and
    their count; the tied head and its softmax run ``head_rows`` tokens at a
    time."""
    h = hidden(weights, cfg, tokens, quant)
    h = h.reshape(-1, h.shape[-1])
    t = targets.reshape(-1).long()
    head = weights["embed"].T
    total = h.new_zeros(())
    for i in range(0, h.shape[0], head_rows):
        hx, tx = h[i:i + head_rows], t[i:i + head_rows]
        logits = _mm(hx, head, quant)
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, tx.clamp(min=0)[:, None])[:, 0]
        total = total + torch.where(tx >= 0, nll, 0.0).sum()
    return total, int((t >= 0).sum())


def loss(weights: dict, cfg: dict, tokens: torch.Tensor, targets: torch.Tensor, *,
         quant: str | None = None, row_block: int = 2) -> float:
    """The mean loss over a batch, ``row_block`` rows at a time."""
    total, count = 0.0, 0
    with torch.no_grad(), exact_float32():
        for i in range(0, tokens.shape[0], row_block):
            s, n = token_losses_sum(weights, cfg, tokens[i:i + row_block], targets[i:i + row_block],
                                    quant=quant)
            total += float(s)
            count += n
    return total / max(count, 1)
