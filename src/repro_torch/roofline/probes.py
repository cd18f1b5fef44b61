"""Roofline probing by layer count.

The port of ``repro.roofline.probes``.  XLA's cost analysis counts a
while-loop body ONCE regardless of trip count, so the reference lowers two
small UNROLLED variants of the same cell — ``a`` layers and ``2a`` layers
(a = hybrid period for zamba2, else 1) — measures exact totals, and
reconstructs:

    per_layer = (U_2a − U_a) / a
    total(L)  = (U_a − a·per_layer) + L·per_layer

The port's dry run traces eagerly and counts every layer, so it has no
trip-count problem; the probes are kept so that a record holds both, and
they agree with the direct count exactly for homogeneous stacks.  For the
hybrid the shared block's contribution is averaged into per_layer (L/a
applications assumed — 13.5 against the true 13 for 81 layers), which is
where the two differ.  Counts are per device, as the dry run's.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeConfig
from .analysis import COLLECTIVES

__all__ = ["probe_corrected_costs"]


def _probe_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    kw: dict = {"n_layers": n_layers, "scan_layers": False}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def _measure(cfg: ModelConfig, mesh, shape: ShapeConfig, hp=None) -> dict:
    from ..launch.dryrun import trace_cell

    counts = trace_cell(cfg, mesh, shape, hp=hp)
    out = {
        "flops": counts["flops"],
        "bytes": counts["bytes"],
        "coll_total": counts["coll_total"],
    }
    for op in COLLECTIVES:
        out[f"coll_{op}"] = float(counts["bytes_by_op"].get(op, 0.0))
    return out


def probe_corrected_costs(cfg: ModelConfig, mesh, shape: ShapeConfig, hp=None) -> dict:
    """Returns corrected totals for the REAL layer count of `cfg`; ``mesh`` is
    the ``DeviceMesh`` the dry run traces on."""
    a = cfg.hybrid_attn_every if cfg.family == "hybrid" and cfg.hybrid_attn_every else 1
    u_a = _measure(_probe_cfg(cfg, a), mesh, shape, hp=hp)
    u_2a = _measure(_probe_cfg(cfg, 2 * a), mesh, shape, hp=hp)
    L = cfg.n_layers
    corrected = {}
    for k in u_a:
        per_layer = (u_2a[k] - u_a[k]) / a
        non_scan = u_a[k] - a * per_layer
        corrected[k] = max(0.0, non_scan + L * per_layer)
    corrected["probe_a"] = a
    corrected["probe_raw"] = {"U_a": u_a, "U_2a": u_2a}
    return corrected
