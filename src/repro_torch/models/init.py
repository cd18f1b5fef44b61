"""Parameters of the dense family as ``nn.Module``s, drawn or carried over.

The reference keeps its parameters as a pytree with layer-stacked leaves
(``params["blocks"]["wq"]`` of shape (L, D, H, hd)).  The port keeps one
:class:`ParamDict` per layer in a ``ModuleList``, with every parameter named
like the reference's key: ``params["blocks"][i]["wq"]`` has shape
(D, H, hd).  :func:`init_params` draws the reference's distributions from a
``torch.Generator`` (it does not reproduce JAX's random numbers);
:func:`params_from_numpy` carries a reference pytree across, given as numpy
arrays.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device

__all__ = ["ParamDict", "DenseParams", "init_params", "params_from_numpy", "torch_dtype"]

_ROADMAP_ITEM = {"moe": 6, "ssm": 5, "hybrid": 5, "audio": 6, "vlm": 6}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, name)


def require_dense(cfg: ModelConfig, what: str) -> None:
    """Raise NotImplementedError for a family this slice does not port."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} for the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1, item {_ROADMAP_ITEM.get(cfg.family, 6)}); "
            "repro_torch serves the dense family"
        )


class ParamDict(nn.Module):
    """Named parameters, read as ``p["wq"]`` like the reference's pytree."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class DenseParams(nn.Module):
    """The dense family's parameters: ``embed``, ``blocks`` (one ParamDict per
    layer), ``final_norm`` and, unless tied, ``lm_head``."""

    def __init__(self, embed: torch.Tensor, blocks: list[Mapping[str, torch.Tensor]],
                 final_norm: torch.Tensor, lm_head: torch.Tensor | None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(ParamDict(b) for b in blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)

    def __getitem__(self, name: str):
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _block_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """One layer's shapes (``repro/models/init.py::_attn_shapes`` + ``_ffn_shapes``)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    s: dict[str, tuple] = {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads, hd),
        "wk": (d, cfg.n_kv_heads, hd),
        "wv": (d, cfg.n_kv_heads, hd),
        "wo": (cfg.n_heads, hd, d),
        "ffn_norm": (d,),
        "w_gate": (d, cfg.d_ff),
        "w_up": (d, cfg.d_ff),
        "w_down": (cfg.d_ff, d),
    }
    if cfg.qkv_bias:
        s["bq"] = (cfg.n_heads, hd)
        s["bk"] = (cfg.n_kv_heads, hd)
        s["bv"] = (cfg.n_kv_heads, hd)
    return s


def _fan_in(name: str, shape: tuple) -> int:
    """As ``repro/models/init.py::_init_tree``: the first axis, or the first
    two for the output projection."""
    fan_in = shape[0] * shape[1] if name == "wo" else shape[0]
    return max(1, fan_in)


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> DenseParams:
    """Random parameters of the dense family, with the reference's distributions.

    Matrices (and the QKV biases, which the reference draws the same way) are
    normal / sqrt(fan_in) drawn in float32 and cast to ``cfg.dtype``; norm
    scales are 1.  The draws run on ``generator``'s device and land on
    ``device`` (default: :func:`repro_torch.device.default_device`).
    """
    require_dense(cfg, "init_params")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
        return (x / math.sqrt(fan_in)).to(device=dev, dtype=dtype)

    def ones(shape: tuple) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=dev)

    embed = dense((cfg.padded_vocab, cfg.d_model), cfg.d_model)
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            name: ones(shape) if name.endswith("norm") else dense(shape, _fan_in(name, shape))
            for name, shape in sorted(_block_shapes(cfg).items())
        })
    lm_head = None if cfg.tie_embeddings else dense((cfg.d_model, cfg.padded_vocab), cfg.d_model)
    return DenseParams(embed, blocks, ones((cfg.d_model,)), lm_head)


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch.from_numpy refuses it
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *, device=None) -> DenseParams:
    """Carry the reference's parameter pytree across, as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, params)``); bf16 leaves go through a
    uint16 view.  Layer-stacked leaves are split per layer."""
    require_dense(cfg, "params_from_numpy")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    names = set(_block_shapes(cfg))
    if set(tree["blocks"]) != names:
        raise ValueError(f"blocks hold {sorted(tree['blocks'])}, the config needs {sorted(names)}")
    stacked = {name: _tensor(a, dev, dtype) for name, a in tree["blocks"].items()}
    blocks = [{name: t[i] for name, t in sorted(stacked.items())} for i in range(cfg.n_layers)]
    lm_head = None if cfg.tie_embeddings else _tensor(tree["lm_head"], dev, dtype)
    return DenseParams(_tensor(tree["embed"], dev, dtype), blocks,
                       _tensor(tree["final_norm"], dev, dtype), lm_head)
