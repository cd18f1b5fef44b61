"""Assigned-architecture registry: ``get_config(arch_id)`` / ``--arch <id>``."""

from __future__ import annotations

from .base import (
    SHAPES,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    reduced,
)

from .zamba2_7b import CONFIG as zamba2_7b
from .zamba2_7b_instruct import CONFIG as zamba2_7b_instruct
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .phi35_moe_42b import CONFIG as phi35_moe_42b
from .whisper_tiny import CONFIG as whisper_tiny
from .mamba2_370m import CONFIG as mamba2_370m
from .internlm2_20b import CONFIG as internlm2_20b
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from .qwen25_3b import CONFIG as qwen25_3b
from .yi_34b import CONFIG as yi_34b
from .internvl2_76b import CONFIG as internvl2_76b
from .nwp_100m import CONFIG as nwp_100m

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        zamba2_7b,
        granite_moe_3b_a800m,
        phi35_moe_42b,
        whisper_tiny,
        mamba2_370m,
        internlm2_20b,
        phi3_mini_3_8b,
        qwen25_3b,
        yi_34b,
        internvl2_76b,
        nwp_100m,
        zamba2_7b_instruct,
    ]
}

#: the reference package's assigned architectures (the dry run's cells); the
#: port's published Zamba2 runs in the benchmark's scoring cell, not there
ASSIGNED = [n for n in ARCHS if n not in ("nwp-100m", "zamba2-7b-instruct")]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS",
    "ASSIGNED",
    "get_config",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "MeshConfig",
    "TrainConfig",
    "SHAPES",
    "reduced",
]
