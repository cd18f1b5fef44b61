"""zamba2-7b — Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242; unverified]  81L d_model=3584 32H(kv=32) d_ff=14336
vocab=32000 ssm_state=64.  The shared block consumes concat(h, x_emb) (2·d)
and projects back to d (Zamba2-style weight sharing); head_dim=112 keeps
32 heads mapping back onto d_model.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, d_conv=4, expand=2),
    hybrid_attn_every=6,
    sub_quadratic=True,
)
