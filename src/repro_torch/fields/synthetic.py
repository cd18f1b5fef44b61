"""Synthetic global weather fields for the NWP-driver examples/benchmarks.

Cheap spectral synthesis: a few random low-order zonal/meridional harmonics
plus noise — smooth, bounded 2-D fields resembling global analysis slices,
deterministic per (param, member, step).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_field", "FIELD_BASE"]

FIELD_BASE = {
    "2t": (288.0, 15.0),    # 2m temperature [K]
    "10u": (0.0, 8.0),      # 10m U wind [m/s]
    "10v": (0.0, 8.0),
    "msl": (101325.0, 800.0),  # mean sea-level pressure [Pa]
    "t": (250.0, 20.0),
    "u": (0.0, 12.0),
    "v": (0.0, 12.0),
    "q": (0.004, 0.002),    # specific humidity [kg/kg]
}


def synthetic_field(
    param: str = "2t",
    member: int = 0,
    step: int = 0,
    *,
    nlat: int = 181,
    nlon: int = 360,
    n_modes: int = 6,
) -> np.ndarray:
    """(nlat, nlon) float32 field, deterministic in (param, member, step)."""
    base, scale = FIELD_BASE.get(param, (0.0, 1.0))
    seed = abs(hash((param, member, step))) % (2**31)
    rng = np.random.default_rng(seed)
    lat = np.linspace(-np.pi / 2, np.pi / 2, nlat)[:, None]
    lon = np.linspace(0, 2 * np.pi, nlon, endpoint=False)[None, :]
    f = np.zeros((nlat, nlon))
    for _ in range(n_modes):
        k = rng.integers(1, 6)
        m = rng.integers(0, 5)
        amp = rng.normal() / (1 + k + m)
        phase = rng.uniform(0, 2 * np.pi)
        f += amp * np.cos(m * lon + phase) * np.cos(lat) ** k
    # gentle temporal evolution so consecutive steps correlate
    f = f + 0.1 * step * np.cos(lon + 0.3 * step) * np.cos(lat)
    f = f / max(np.abs(f).std(), 1e-9)
    return (base + scale * f).astype(np.float32)
