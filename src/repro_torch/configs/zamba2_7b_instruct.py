"""zamba2-7b-instruct — Zamba2-7B-Instruct at its published widths.

Source: https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json
(Zyphra's Zamba2 report, arXiv:2411.15242; the layer equations of
transformers' ``modeling_zamba2.py``).  81 Mamba2 layers of d_model 3584,
d_inner 7168 in 112 heads of 64, two groups of B and C (d_state 64), chunk
256; two shared attention + MLP blocks used in turn (A, B, A, ...) at the 13
``hybrid_layer_ids``, each over concat(h, x0) (7168 wide) with 32 heads of
224, RoPE over all 224 dims and the softmax scale (224 / 2)^-0.5; the gated
GELU MLP (14336) with a rank-128 LoRA adapter per site; a 3584 x 3584 linear
per site whose output is added to that layer's mixer input.  The LM head is
tied to the embedding (Zamba2Config's default ``tie_word_embeddings``).
``zamba2-7b`` is the reference package's own hybrid and stays as it is.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab=32000,
    tie_embeddings=True,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    max_seq_len=4096,
    ssm=SSMConfig(d_state=64, head_dim=64, d_conv=4, expand=2, chunk=256, ngroups=2),
    hybrid_sites=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_shared_blocks=2,
    adapter_rank=128,
    ffn_act="gelu",
    attn_scale=112 ** -0.5,
    sub_quadratic=True,
)
