"""qwen2.5-3b — dense GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-*; hf]
36L d_model=2048 16H(kv=2) d_ff=11008 vocab=151936."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
)
