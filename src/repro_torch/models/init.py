"""Parameters of every model family as ``nn.Module``s, drawn or carried over.

The reference keeps its parameters as a pytree with layer-stacked leaves
(``params["blocks"]["wq"]`` of shape (L, D, H, hd)).  The port keeps one
:class:`ParamDict` per layer in a ``ModuleList``, with every parameter named
like the reference's key: ``params["blocks"][i]["wq"]`` has shape
(D, H, hd).  The same holds for the encoder's ``enc_blocks`` and the
decoder's ``cross`` attention of the audio family; the hybrid family's one
``shared`` block is a single :class:`ParamDict`.  :func:`init_params` draws
the reference's distributions from a ``torch.Generator`` (it does not
reproduce JAX's random numbers); :func:`params_from_numpy` carries a
reference pytree across, given as numpy arrays.  ``A_log`` and ``D_skip`` of
the ssm and hybrid families stay float32 in a bf16 model, as in the
reference.
:func:`logical_axes` names every parameter's axes for
:mod:`repro_torch.distributed.sharding`, and :func:`abstract_params` makes the
parameters on the meta device, shapes and dtypes without storage.

Parameters are made with ``requires_grad=False``, which is what serving and
scoring want; a trainer switches them on with ``params.requires_grad_(True)``.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device

__all__ = ["ParamDict", "ModelParams", "abstract_params", "init_params", "logical_axes",
           "params_from_numpy", "torch_dtype"]

#: leaves kept in float32 whatever the model dtype (``repro/models/init.py:201-206``)
FLOAT32_LEAVES = ("A_log", "D_skip")
#: the parts of a model besides ``blocks`` that hold layers (reference order)
LAYER_LISTS = ("enc_blocks", "cross")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, name)


class ParamDict(nn.Module):
    """Named parameters, read as ``p["wq"]`` like the reference's pytree."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def tree(self) -> dict[str, nn.Parameter]:
        return dict(self.named_parameters())

    @torch.no_grad()
    def copy_from(self, tree: Mapping) -> None:
        for name, p in self.named_parameters():
            p.copy_(tree[name])


class ModelParams(nn.Module):
    """A model's parameters: ``embed``, ``blocks`` (one ParamDict per layer),
    ``final_norm`` and, unless tied, ``lm_head``; the hybrid family adds its
    ``shared`` block, the audio family its encoder (``enc_blocks``,
    ``enc_final_norm``) and the decoder's ``cross`` attention, one ParamDict
    per layer."""

    def __init__(self, embed: torch.Tensor, blocks: list[Mapping[str, torch.Tensor]],
                 final_norm: torch.Tensor, lm_head: torch.Tensor | None, *,
                 shared: Mapping[str, torch.Tensor] | None = None,
                 enc_blocks: list[Mapping[str, torch.Tensor]] | None = None,
                 enc_final_norm: torch.Tensor | None = None,
                 cross: list[Mapping[str, torch.Tensor]] | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(ParamDict(b) for b in blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)
        if shared is not None:
            self.shared = ParamDict(shared)
        if enc_blocks is not None:
            self.enc_blocks = nn.ModuleList(ParamDict(b) for b in enc_blocks)
            self.enc_final_norm = nn.Parameter(enc_final_norm, requires_grad=False)
            self.cross = nn.ModuleList(ParamDict(c) for c in cross)

    def __getitem__(self, name: str):
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> dict:
        """The parameters as the reference's pytree, with ``blocks`` (and
        ``enc_blocks``, ``cross``) a list of per-layer dicts:
        ``{"embed": p, "blocks": [{"wq": p, ...}, ...], ...}``."""
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        for name in ("blocks", *LAYER_LISTS):
            if hasattr(self, name):
                out[name] = [bp.tree() for bp in self[name]]
        if hasattr(self, "shared"):
            out["shared"] = self.shared.tree()
        return out

    @classmethod
    def from_tree(cls, tree: Mapping) -> "ModelParams":
        """The parameters of a tree shaped like :meth:`tree`, its tensors held
        as they are (DTensors, fake tensors)."""
        return cls(tree["embed"], tree["blocks"], tree["final_norm"], tree.get("lm_head"),
                   shared=tree.get("shared"), enc_blocks=tree.get("enc_blocks"),
                   enc_final_norm=tree.get("enc_final_norm"), cross=tree.get("cross"))

    @torch.no_grad()
    def copy_from(self, tree: Mapping) -> None:
        """Copy a tree shaped like :meth:`tree` into the parameters, in place,
        casting each leaf to its parameter's dtype and device."""
        for name, p in self.named_parameters(recurse=False):
            p.copy_(tree[name])
        for name in ("blocks", *LAYER_LISTS):
            if not hasattr(self, name):
                continue
            if len(tree[name]) != len(self[name]):
                raise ValueError(f"tree has {len(tree[name])} {name}, the model {len(self[name])}")
            for bp, src in zip(self[name], tree[name]):
                bp.copy_from(src)
        if hasattr(self, "shared"):
            self.shared.copy_from(tree["shared"])


def _attn_shapes(cfg: ModelConfig, width_in: int) -> dict[str, tuple]:
    """``repro/models/init.py::_attn_shapes``."""
    hd = cfg.resolved_head_dim
    s: dict[str, tuple] = {
        "attn_norm": (width_in,),
        "wq": (width_in, cfg.n_heads, hd),
        "wk": (width_in, cfg.n_kv_heads, hd),
        "wv": (width_in, cfg.n_kv_heads, hd),
        "wo": (cfg.n_heads, hd, cfg.d_model),
    }
    if cfg.qkv_bias:
        s["bq"] = (cfg.n_heads, hd)
        s["bk"] = (cfg.n_kv_heads, hd)
        s["bv"] = (cfg.n_kv_heads, hd)
    return s


def _ffn_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """``repro/models/init.py::_ffn_shapes``."""
    return {
        "ffn_norm": (cfg.d_model,),
        "w_gate": (cfg.d_model, cfg.d_ff),
        "w_up": (cfg.d_model, cfg.d_ff),
        "w_down": (cfg.d_ff, cfg.d_model),
    }


def _moe_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """``repro/models/init.py::_moe_shapes``: padded expert slots are
    router-masked, never routed to."""
    m = cfg.moe
    e = m.e_total
    return {
        "ffn_norm": (cfg.d_model,),
        "router": (cfg.d_model, e),
        "w_gate": (e, cfg.d_model, m.d_expert),
        "w_up": (e, cfg.d_model, m.d_expert),
        "w_down": (e, m.d_expert, cfg.d_model),
    }


def _ssm_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """``repro/models/init.py::_ssm_shapes``."""
    di, n, h, k = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads, cfg.ssm.d_conv
    return {
        "norm_in": (cfg.d_model,),
        "w_z": (cfg.d_model, di),
        "w_x": (cfg.d_model, di),
        "w_B": (cfg.d_model, n),
        "w_C": (cfg.d_model, n),
        "w_dt": (cfg.d_model, h),
        "dt_bias": (h,),
        "conv_x": (k, di),
        "conv_x_b": (di,),
        "conv_B": (k, n),
        "conv_B_b": (n,),
        "conv_C": (k, n),
        "conv_C_b": (n,),
        "A_log": (h,),
        "D_skip": (h,),
        "norm": (di,),
        "out_proj": (di, cfg.d_model),
    }


def _block_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """One layer's shapes (``repro/models/init.py::_block_shapes``)."""
    if cfg.family in ("ssm", "hybrid"):
        return _ssm_shapes(cfg)
    if cfg.family == "moe":
        return {**_attn_shapes(cfg, cfg.d_model), **_moe_shapes(cfg)}
    return {**_attn_shapes(cfg, cfg.d_model), **_ffn_shapes(cfg)}


def _shared_block_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """The zamba2-style shared attention + FFN block, attention over
    concat(h, x0) (2·d), ``repro/models/init.py::_shared_block_shapes``."""
    return {**_attn_shapes(cfg, 2 * cfg.d_model), **_ffn_shapes(cfg)}


def _cross_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """One decoder layer's cross-attention (``_encdec_extra_shapes``'s ``cross``);
    the encoder's layers are dense blocks."""
    hd = cfg.resolved_head_dim
    return {
        "xattn_norm": (cfg.d_model,),
        "xwq": (cfg.d_model, cfg.n_heads, hd),
        "xwk": (cfg.d_model, cfg.n_kv_heads, hd),
        "xwv": (cfg.d_model, cfg.n_kv_heads, hd),
        "xwo": (cfg.n_heads, hd, cfg.d_model),
    }


_ATTN_AXES = {
    "attn_norm": ("d_model",),
    "wq": ("d_model", "heads", "head_dim"),
    "wk": ("d_model", "kv_heads", "head_dim"),
    "wv": ("d_model", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "d_model"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
}

_FFN_AXES = {
    "ffn_norm": ("d_model",),
    "w_gate": ("d_model", "d_ff"),
    "w_up": ("d_model", "d_ff"),
    "w_down": ("d_ff", "d_model"),
}

_MOE_AXES = {
    "ffn_norm": ("d_model",),
    "router": ("d_model", "experts"),
    "w_gate": ("experts", "d_model", "d_expert"),
    "w_up": ("experts", "d_model", "d_expert"),
    "w_down": ("experts", "d_expert", "d_model"),
}

_SSM_AXES = {
    "norm_in": ("d_model",),
    "w_z": ("d_model", "ssm_inner"),
    "w_x": ("d_model", "ssm_inner"),
    "w_B": ("d_model", "ssm_state"),
    "w_C": ("d_model", "ssm_state"),
    "w_dt": ("d_model", "ssm_heads"),
    "dt_bias": ("ssm_heads",),
    "conv_x": ("conv_width", "ssm_inner"),
    "conv_x_b": ("ssm_inner",),
    "conv_B": ("conv_width", "ssm_state"),
    "conv_B_b": ("ssm_state",),
    "conv_C": ("conv_width", "ssm_state"),
    "conv_C_b": ("ssm_state",),
    "A_log": ("ssm_heads",),
    "D_skip": ("ssm_heads",),
    "norm": ("ssm_inner",),
    "out_proj": ("ssm_inner", "d_model"),
}

_CROSS_AXES = {
    "xattn_norm": ("d_model",),
    "xwq": ("d_model", "heads", "head_dim"),
    "xwk": ("d_model", "kv_heads", "head_dim"),
    "xwv": ("d_model", "kv_heads", "head_dim"),
    "xwo": ("heads", "head_dim", "d_model"),
}


def _attn_axes(cfg: ModelConfig) -> dict[str, tuple]:
    axes = dict(_ATTN_AXES)
    if not cfg.qkv_bias:
        for b in ("bq", "bk", "bv"):
            axes.pop(b)
    return axes


def _block_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """One layer's logical axes (``repro/models/init.py::_block_axes``)."""
    if cfg.family in ("ssm", "hybrid"):
        return dict(_SSM_AXES)
    if cfg.family == "moe":
        return {**_attn_axes(cfg), **_MOE_AXES}
    return {**_attn_axes(cfg), **_FFN_AXES}


def _has_shared(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid" and bool(cfg.hybrid_attn_every)


def _layer_shapes(cfg: ModelConfig) -> dict[str, tuple[dict[str, tuple], int]]:
    """Every layer list of the model: name -> (one layer's shapes, layers)."""
    out = {"blocks": (_block_shapes(cfg), cfg.n_layers)}
    if cfg.is_encoder_decoder:
        out["enc_blocks"] = ({**_attn_shapes(cfg, cfg.d_model), **_ffn_shapes(cfg)},
                             cfg.encoder_layers)
        out["cross"] = (_cross_shapes(cfg), cfg.n_layers)
    return out


def _fan_in(name: str, shape: tuple) -> int:
    """As ``repro/models/init.py::_init_tree``: the first axis, or the first
    two for the output projections (an expert's weights take the expert
    count, as there)."""
    fan_in = shape[0] * shape[1] if name in ("wo", "xwo") else shape[0]
    return max(1, fan_in)


def _leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if name in FLOAT32_LEAVES else dtype


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> ModelParams:
    """Random parameters of any family, with the reference's distributions
    (``repro/models/init.py::_init_tree``).

    Matrices (and the QKV biases, which the reference draws the same way) are
    normal / sqrt(fan_in) drawn in float32 and cast to ``cfg.dtype``; norm
    scales are 1, conv biases and ``dt_bias`` 0; ``A_log`` is
    log(1 + 15 U[0, 1)) and ``D_skip`` 1, both float32.  The draws run on
    ``generator``'s device and land on ``device`` (default:
    :func:`repro_torch.device.default_device`).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
        return (x / math.sqrt(fan_in)).to(device=dev, dtype=dtype)

    def leaf(name: str, shape: tuple) -> torch.Tensor:
        if name.endswith(("norm", "_b", "norm_in")) or name == "dt_bias":
            fill = torch.ones if "norm" in name else torch.zeros
            return fill(shape, dtype=dtype, device=dev)
        if name == "A_log":  # A in [1, 16) as in Mamba2
            u = torch.rand(shape, generator=generator, dtype=torch.float32, device=generator.device)
            return torch.log(1.0 + 15.0 * u).to(dev)
        if name == "D_skip":
            return torch.ones(shape, dtype=torch.float32, device=dev)
        return dense(shape, _fan_in(name, shape))

    def layers(shapes: dict[str, tuple], n: int) -> list[dict[str, torch.Tensor]]:
        return [{name: leaf(name, shape) for name, shape in sorted(shapes.items())}
                for _ in range(n)]

    embed = dense((cfg.padded_vocab, cfg.d_model), cfg.d_model)
    stacks = {name: layers(shapes, n) for name, (shapes, n) in _layer_shapes(cfg).items()}
    lm_head = None if cfg.tie_embeddings else dense((cfg.d_model, cfg.padded_vocab), cfg.d_model)
    extra: dict = {}
    if _has_shared(cfg):
        extra["shared"] = layers(_shared_block_shapes(cfg), 1)[0]
    if cfg.is_encoder_decoder:
        extra.update(enc_blocks=stacks["enc_blocks"], cross=stacks["cross"],
                     enc_final_norm=torch.ones((cfg.d_model,), dtype=dtype, device=dev))
    return ModelParams(embed, stacks["blocks"], torch.ones((cfg.d_model,), dtype=dtype, device=dev),
                       lm_head, **extra)


def logical_axes(cfg: ModelConfig) -> dict:
    """A tuple of logical axis names per parameter, in the tree layout of
    :meth:`ModelParams.tree`: ``blocks`` (and ``enc_blocks``, ``cross``) is a
    list of per-layer dicts, so the reference's leading ``"layers"`` axis
    is not there (``repro/models/init.py::logical_axes``)."""
    block_axes = {"blocks": _block_axes(cfg), "enc_blocks": {**_attn_axes(cfg), **_FFN_AXES},
                  "cross": dict(_CROSS_AXES)}
    axes: dict = {"embed": ("vocab", "d_model"), "final_norm": ("d_model",)}
    for name, (_, n) in _layer_shapes(cfg).items():
        axes[name] = [dict(block_axes[name]) for _ in range(n)]
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("d_model", "vocab")
    if _has_shared(cfg):
        axes["shared"] = {**_attn_axes(cfg), **_FFN_AXES}
    if cfg.is_encoder_decoder:
        axes["enc_final_norm"] = ("d_model",)
    return axes


def abstract_params(cfg: ModelConfig) -> ModelParams:
    """The model's parameters on the meta device: the shapes and dtypes of
    :func:`init_params` (``A_log`` and ``D_skip`` float32) with no storage,
    the counterpart of the reference's ``ShapeDtypeStruct`` tree
    (``repro/models/init.py::abstract_params``)."""
    dtype = torch_dtype(cfg.dtype)

    def empty(name: str, shape: tuple) -> torch.Tensor:
        return torch.empty(shape, dtype=_leaf_dtype(name, dtype), device="meta")

    def layer(shapes: dict[str, tuple]) -> dict[str, torch.Tensor]:
        return {name: empty(name, shape) for name, shape in sorted(shapes.items())}

    stacks = {name: [layer(shapes) for _ in range(n)]
              for name, (shapes, n) in _layer_shapes(cfg).items()}
    vector = empty("final_norm", (cfg.d_model,))
    lm_head = None if cfg.tie_embeddings else empty("lm_head", (cfg.d_model, cfg.padded_vocab))
    extra: dict = {}
    if _has_shared(cfg):
        extra["shared"] = layer(_shared_block_shapes(cfg))
    if cfg.is_encoder_decoder:
        extra.update(enc_blocks=stacks["enc_blocks"], cross=stacks["cross"],
                     enc_final_norm=empty("enc_final_norm", (cfg.d_model,)))
    return ModelParams(empty("embed", (cfg.padded_vocab, cfg.d_model)), stacks["blocks"],
                       vector, lm_head, **extra)


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch.from_numpy refuses it
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *, device=None) -> ModelParams:
    """Carry the reference's parameter pytree across, as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, params)``); bf16 leaves go through a
    uint16 view.  Layer-stacked leaves are split per layer."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def leaves(part: str, src: Mapping, shapes: dict[str, tuple]) -> dict[str, torch.Tensor]:
        if set(src) != set(shapes):
            raise ValueError(f"{part} hold {sorted(src)}, the config needs {sorted(shapes)}")
        return {name: _tensor(a, dev, _leaf_dtype(name, dtype)) for name, a in sorted(src.items())}

    stacks = {}
    for part, (shapes, n) in _layer_shapes(cfg).items():
        stacked = leaves(part, tree[part], shapes)
        stacks[part] = [{name: t[i] for name, t in stacked.items()} for i in range(n)]
    lm_head = None if cfg.tie_embeddings else _tensor(tree["lm_head"], dev, dtype)
    extra: dict = {}
    if _has_shared(cfg):
        extra["shared"] = leaves("shared", tree["shared"], _shared_block_shapes(cfg))
    if cfg.is_encoder_decoder:
        extra.update(enc_blocks=stacks["enc_blocks"], cross=stacks["cross"],
                     enc_final_norm=_tensor(tree["enc_final_norm"], dev, dtype))
    return ModelParams(_tensor(tree["embed"], dev, dtype), stacks["blocks"],
                       _tensor(tree["final_norm"], dev, dtype), lm_head, **extra)
