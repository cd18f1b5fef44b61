"""Parameters of the dense and ssm families as ``nn.Module``s, drawn or carried over.

The reference keeps its parameters as a pytree with layer-stacked leaves
(``params["blocks"]["wq"]`` of shape (L, D, H, hd)).  The port keeps one
:class:`ParamDict` per layer in a ``ModuleList``, with every parameter named
like the reference's key: ``params["blocks"][i]["wq"]`` has shape
(D, H, hd).  :func:`init_params` draws the reference's distributions from a
``torch.Generator`` (it does not reproduce JAX's random numbers);
:func:`params_from_numpy` carries a reference pytree across, given as numpy
arrays.  ``A_log`` and ``D_skip`` of the ssm family stay float32 in a bf16
model, as in the reference.

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

__all__ = ["ParamDict", "ModelParams", "init_params", "params_from_numpy", "torch_dtype"]

_ROADMAP_ITEM = {"ssm": 4, "hybrid": 5, "moe": 6, "vlm": 6, "audio": 7}
#: leaves kept in float32 whatever the model dtype (``repro/models/init.py:201-206``)
FLOAT32_LEAVES = ("A_log", "D_skip")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, name)


def require_family(cfg: ModelConfig, what: str, families: tuple[str, ...] = ("dense",)) -> None:
    """Raise NotImplementedError for a family that ``what`` is not ported for."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"{what} for the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1, item {_ROADMAP_ITEM.get(cfg.family, 6)}); "
            f"repro_torch runs it for the {' and '.join(families)} famil"
            f"{'ies' if len(families) > 1 else 'y'}"
        )


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


class ModelParams(nn.Module):
    """A model's parameters: ``embed``, ``blocks`` (one ParamDict per layer),
    ``final_norm`` and, unless tied, ``lm_head``."""

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

    def tree(self) -> dict:
        """The parameters as the reference's pytree, with ``blocks`` a list of
        per-layer dicts: ``{"embed": p, "blocks": [{"wq": p, ...}, ...], ...}``."""
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out["blocks"] = [bp.tree() for bp in self.blocks]
        return out

    @torch.no_grad()
    def copy_from(self, tree: Mapping) -> None:
        """Copy a tree shaped like :meth:`tree` into the parameters, in place,
        casting each leaf to its parameter's dtype and device."""
        for name, p in self.named_parameters(recurse=False):
            p.copy_(tree[name])
        if len(tree["blocks"]) != len(self.blocks):
            raise ValueError(f"tree has {len(tree['blocks'])} layers, the model {len(self.blocks)}")
        for bp, src in zip(self.blocks, tree["blocks"]):
            for name, p in bp.named_parameters():
                p.copy_(src[name])


def _attn_ffn_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """``repro/models/init.py::_attn_shapes`` + ``_ffn_shapes``."""
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
    """One layer's shapes."""
    return _ssm_shapes(cfg) if cfg.family == "ssm" else _attn_ffn_shapes(cfg)


def _fan_in(name: str, shape: tuple) -> int:
    """As ``repro/models/init.py::_init_tree``: the first axis, or the first
    two for the output projection."""
    fan_in = shape[0] * shape[1] if name == "wo" else shape[0]
    return max(1, fan_in)


def _leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if name in FLOAT32_LEAVES else dtype


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> ModelParams:
    """Random parameters of the dense or ssm family, with the reference's
    distributions (``repro/models/init.py::_init_tree``).

    Matrices (and the QKV biases, which the reference draws the same way) are
    normal / sqrt(fan_in) drawn in float32 and cast to ``cfg.dtype``; norm
    scales are 1, conv biases and ``dt_bias`` 0; ``A_log`` is
    log(1 + 15 U[0, 1)) and ``D_skip`` 1, both float32.  The draws run on
    ``generator``'s device and land on ``device`` (default:
    :func:`repro_torch.device.default_device`).
    """
    require_family(cfg, "init_params", ("dense", "ssm"))
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

    embed = dense((cfg.padded_vocab, cfg.d_model), cfg.d_model)
    shapes = sorted(_block_shapes(cfg).items())
    blocks = [{name: leaf(name, shape) for name, shape in shapes} for _ in range(cfg.n_layers)]
    lm_head = None if cfg.tie_embeddings else dense((cfg.d_model, cfg.padded_vocab), cfg.d_model)
    return ModelParams(embed, blocks, torch.ones((cfg.d_model,), dtype=dtype, device=dev), lm_head)


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
    require_family(cfg, "params_from_numpy", ("dense", "ssm"))
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    names = set(_block_shapes(cfg))
    if set(tree["blocks"]) != names:
        raise ValueError(f"blocks hold {sorted(tree['blocks'])}, the config needs {sorted(names)}")
    stacked = {name: _tensor(a, dev, _leaf_dtype(name, dtype)) for name, a in tree["blocks"].items()}
    blocks = [{name: t[i] for name, t in sorted(stacked.items())} for i in range(cfg.n_layers)]
    lm_head = None if cfg.tie_embeddings else _tensor(tree["lm_head"], dev, dtype)
    return ModelParams(_tensor(tree["embed"], dev, dtype), blocks,
                       _tensor(tree["final_norm"], dev, dtype), lm_head)
