"""whisper-tiny — encoder-decoder; conv frontend stubbed.

[arXiv:2212.04356; unverified]  4L enc + 4L dec, d_model=384 6H(kv=6)
d_ff=1536 vocab=51865.  ``input_specs()`` supplies precomputed frame
embeddings (batch, frames, 384) — the conv1d stem is a modality stub.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    encoder_layers=4,
    is_encoder_decoder=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    input_kind="frames",
    tie_embeddings=True,
)
