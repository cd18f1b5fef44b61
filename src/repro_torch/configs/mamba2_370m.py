"""mamba2-370m — pure SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  48L d_model=1024 ssm_state=128 vocab=50280.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, d_conv=4, expand=2),
    sub_quadratic=True,
)
