"""Logical-axis sharding hooks for the port's model code.

The reference's ``constrain`` applies a sharding constraint by logical axis
names when a rules context is active.  On one card there is nothing to
shard, so here it only checks the rank as the reference does
(``repro/distributed/sharding.py:67-68``) and returns ``x`` itself.  Axis
rules, meshes and ZeRO-1 specs come with ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import torch

__all__ = ["constrain"]


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Check that ``x`` has one logical name per axis; return it unchanged."""
    if x.ndim != len(logical):
        raise ValueError(f"constrain: rank {x.ndim} != {len(logical)} logical names")
    return x
