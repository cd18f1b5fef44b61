"""internvl2-76b — InternViT + LM backbone; ViT frontend stubbed.

[arXiv:2404.16821; unverified]  80L d_model=8192 64H(kv=8) d_ff=28672
vocab=128256.  ``input_specs()`` supplies precomputed patch embeddings;
the transformer backbone below is the graded component.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    input_kind="patches",
)
