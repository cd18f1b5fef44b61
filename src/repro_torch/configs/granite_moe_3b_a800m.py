"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-*-base; hf]  32L d_model=1536 24H(kv=8)
per-expert d_ff=512 vocab=49155.  (The pool bracket note says "32 experts",
matching the 1b-a400m sibling; we follow the explicit "MoE 40e top-8".)
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
)
