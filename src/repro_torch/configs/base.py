"""Model/run configuration system.

One :class:`ModelConfig` per assigned architecture lives in
``repro/configs/<arch>.py``; shapes are :class:`ShapeConfig`; together with
:class:`MeshConfig` and :class:`TrainConfig` they fully determine a run.

The port's copy adds the options of the published Zamba2 hybrid
(``zamba2-7b-instruct``): grouped B and C in the Mamba2 mixer
(``SSMConfig.ngroups``), the published site list (``hybrid_sites``), several
shared blocks used in turn (``n_shared_blocks``), per-site LoRA adapters on
the shared MLP (``adapter_rank``), its gated-GELU activation (``ffn_act``)
and its attention's softmax scale (``attn_scale``).  Their defaults leave
every config of the reference as it is.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Literal

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "MeshConfig",
    "TrainConfig",
    "SHAPES",
    "reduced",
]

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0           # per-expert FFN width
    group_size: int = 1024      # GShard-style dispatch group
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # EP padding: total expert slots (>= n_experts); padded slots are
    # router-masked so they never receive tokens — lets E shard evenly
    pad_experts_to: int = 0

    @property
    def e_total(self) -> int:
        return max(self.pad_experts_to, self.n_experts)

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0
    head_dim: int = 64
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256            # SSD chunk length
    ngroups: int = 1            # groups of heads that share one B and one C

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int                # query heads; 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2-style): shared attention block applied every k layers
    hybrid_attn_every: int = 0
    # hybrid as Zamba2 publishes it: at each layer of ``hybrid_sites`` the
    # shared block (block s % n_shared_blocks at site s) runs before the
    # mixer and its output, through the site's own linear, is added to the
    # mixer's input only; the block's MLP has a LoRA adapter per site
    hybrid_sites: tuple[int, ...] = ()
    n_shared_blocks: int = 1
    adapter_rank: int = 0
    ffn_act: str = "silu"           # gate activation: 'silu' (SwiGLU) | 'gelu' (exact erf)
    attn_scale: float = 0.0         # softmax scale; 0 -> 1/sqrt(head_dim)
    # encoder-decoder (whisper-style)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # modality frontend stub: 'tokens' | 'frames' | 'patches'
    input_kind: str = "tokens"
    max_seq_len: int = 524_288
    # numerics / implementation knobs (perf levers — see EXPERIMENTS.md §Perf)
    dtype: str = "bfloat16"
    attn_impl: str = "naive"        # 'naive' | 'chunked' | 'pallas'
    attn_chunk: int = 1024          # KV-block for chunked attention
    remat: str = "full"             # 'none' | 'full' | 'dots'
    pad_vocab_multiple: int = 256
    scan_layers: bool = True
    sub_quadratic: bool = False     # set for ssm/hybrid: can run long_500k
    seq_shard: bool = False         # SP: residual stream sharded over model axis
    moe_force_ep: bool = False      # expert parallelism even when E % model != 0
    softmax_dtype: str = "float32"  # attention score/softmax accumulation dtype
    ce_dtype: str = "float32"       # CE logits materialisation dtype

    def __post_init__(self):
        # a JSON list or any sequence: kept as a tuple, so the config stays hashable
        object.__setattr__(self, "hybrid_sites", tuple(self.hybrid_sites))

    @property
    def published_hybrid(self) -> bool:
        """Whether the shared blocks run at ``hybrid_sites``, as Zamba2 publishes."""
        return bool(self.hybrid_sites)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm.enabled else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        def attn_params(width_in: int) -> int:
            return (
                width_in * self.n_heads * hd            # q
                + 2 * width_in * self.n_kv_heads * hd   # k, v
                + self.n_heads * hd * D                 # o
            )
        def dense_ffn() -> int:
            return 3 * D * F  # SwiGLU
        def moe_ffn() -> int:
            m = self.moe
            return D * m.n_experts + m.n_experts * 3 * D * m.d_expert
        def ssm_params() -> int:
            di, st, hds = self.d_inner, self.ssm.ngroups * self.ssm.d_state, self.ssm_heads
            return (
                D * (2 * di + 2 * st + hds)   # in_proj -> z, x, B, C, dt
                + self.ssm.d_conv * (di + 2 * st)  # conv over x,B,C
                + hds * 2                      # A_log, D skip
                + di * D                       # out_proj
            )
        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn_params(D) + dense_ffn() + 2 * D
        elif self.family == "moe":
            per_layer = attn_params(D) + moe_ffn() + 2 * D
        elif self.family == "ssm":
            per_layer = ssm_params() + 2 * D
        elif self.family == "hybrid":
            per_layer = ssm_params() + 2 * D
        n += self.n_layers * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            # one shared attention+ffn block (input = concat(h, x0) -> 2D wide)
            n += attn_params(2 * D) + 3 * D * self.d_ff + 2 * 2 * D
        if self.family == "hybrid" and self.published_hybrid:
            # the shared blocks, and per site the adapter (D -> r -> 2F) and the linear
            n += self.n_shared_blocks * (attn_params(2 * D) + 3 * D * F + 2 * D + D)
            n += len(self.hybrid_sites) * (self.adapter_rank * (D + 2 * F) + D * D)
        if self.is_encoder_decoder:
            # encoder layers + decoder cross-attention
            n += self.encoder_layers * (attn_params(D) + dense_ffn() + 2 * D)
            n += self.n_layers * (attn_params(D) + D)  # cross-attn + norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe.enabled:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        inactive = self.n_layers * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return dict(zip(self.axes, self.shape)).get("model", 1)

    @property
    def batch_size(self) -> int:
        d = dict(zip(self.axes, self.shape))
        return d.get("pod", 1) * d.get("data", 1)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    zero1: bool = True              # shard optimizer state over data axis
    grad_accum: int = 1             # microbatches per step (sequential)
    grad_allreduce_dtype: str = "bfloat16"  # gradient-compression trick
    checkpoint_every: int = 50
    async_checkpoint: bool = True


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        max_seq_len=512,
        dtype="float32",
        pad_vocab_multiple=8,
    )
    if cfg.moe.enabled:
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=32, group_size=32)
    if cfg.ssm.enabled:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
        kw["n_heads"], kw["n_kv_heads"], kw["head_dim"] = 4, 4, 32  # 2*d_model/4
    if cfg.published_hybrid:
        # five layers, sites 1, 3 and 4 (blocks A, B, A), two groups, rank-8 adapters;
        # heads of 32 as above, the softmax scale (head_dim / 2)^-0.5 as published
        kw.update(n_layers=5, hybrid_sites=(1, 3, 4), adapter_rank=8, n_heads=4, n_kv_heads=4,
                  head_dim=32, attn_scale=16 ** -0.5)
        kw["ssm"] = replace(kw["ssm"], ngroups=2)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
    kw.update(over)
    return dataclasses.replace(cfg, **kw)
