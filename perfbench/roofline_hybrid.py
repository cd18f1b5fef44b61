"""Model flops of the published Zamba2 (the ``hybrid`` family), counted from
the configuration's published names, on :mod:`perfbench.roofline`'s counts of
the SSD scan (``ssd_ops``) and of attention (``attention_pairs``).

Two operations per multiply-add.  Per token of a row of ``seq`` tokens:

- every Mamba2 layer's projections (z, x, B, C, dt in; out), its depthwise
  convolution over x, B and C, and its SSD scan, whose heads read their
  group's B and C;
- at each of the ``hybrid_layer_ids``, the shared block's projections (q, k,
  v over concat(h, x0), o), its gated MLP (gate and up, down), the site's
  adapter (rank r in, 2F out) and the site's linear, and its causal
  attention, 4 * head_dim per attended (query, key) pair;
- the LM head.

The embedding is a lookup; norms, gates, RoPE and the softmax are left out,
as MFU conventionally leaves elementwise work out.
"""

from __future__ import annotations

from perfbench import roofline


def padded_vocab(cfg: dict) -> int:
    m = cfg["pad_vocab_size_multiple"]
    return (cfg["vocab_size"] + m - 1) // m * m


def dims(cfg: dict) -> dict:
    """The sizes of a Zamba2 configuration, by its published names."""
    dm = cfg["hidden_size"]
    d_inner = cfg["mamba_expand"] * dm
    if cfg["n_mamba_heads"] * cfg["mamba_headdim"] != d_inner:
        raise ValueError(f"{cfg['n_mamba_heads']} heads of {cfg['mamba_headdim']} are not d_inner {d_inner}")
    return {"d_model": dm, "d_inner": d_inner, "heads": cfg["n_mamba_heads"], "headdim": cfg["mamba_headdim"],
            "d_state": cfg["mamba_d_state"], "ngroups": cfg["mamba_ngroups"], "d_conv": cfg["mamba_d_conv"],
            "chunk": cfg["chunk_size"], "layers": cfg["num_hidden_layers"],
            "attn_width": cfg["attention_hidden_size"], "attn_heads": cfg["num_attention_heads"],
            "kv_heads": cfg["num_key_value_heads"], "head_dim": cfg["attention_head_dim"],
            "ffn": cfg["ffn_hidden_size"], "rank": cfg["adapter_rank"], "blocks": cfg["num_mem_blocks"],
            "sites": list(cfg["hybrid_layer_ids"]), "vocab": padded_vocab(cfg)}


def forward_flops(cfg: dict, seq: int) -> dict[str, float]:
    """One token's forward flops by part: ``mixer_proj``, ``conv``, ``scan``,
    ``shared_proj`` (the shared blocks' and the sites' products), ``attention``
    and ``head``."""
    d = dims(cfg)
    dm, di, n, g, h = d["d_model"], d["d_inner"], d["d_state"], d["ngroups"], d["heads"]
    aw, hq, hk, hd, f, r = d["attn_width"], d["attn_heads"], d["kv_heads"], d["head_dim"], d["ffn"], d["rank"]
    sites, layers = len(d["sites"]), d["layers"]
    proj = dm * (2 * di + 2 * g * n + h) + di * dm
    conv = d["d_conv"] * (di + 2 * g * n)
    q = min(d["chunk"], seq)
    scan = roofline.ssd_ops(h, seq, d["headdim"], n, q, g) / seq
    shared = aw * hq * hd + 2 * aw * hk * hd + hq * hd * dm + 3 * dm * f + r * (dm + 2 * f) + dm * dm
    attention = 4 * hd * hq * roofline.attention_pairs(seq, seq, True) / seq
    return {"mixer_proj": layers * 2 * proj, "conv": layers * 2 * conv, "scan": layers * scan,
            "shared_proj": sites * 2 * shared, "attention": sites * attention, "head": 2 * dm * d["vocab"]}


def forward_flops_per_token(cfg: dict, seq: int) -> float:
    """Model flops of one token's forward pass: the sum of :func:`forward_flops`."""
    return sum(forward_flops(cfg, seq).values())
