"""nwp-100m — the paper-native end-to-end driver model (~100M params).

A small dense LM used by examples/train_lm.py to train for a few hundred
steps on CPU with FDB-backed checkpointing — the workload whose I/O plane
exercises the paper's technique end to end.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nwp-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=2048,
    vocab=32000,
    tie_embeddings=True,
)
