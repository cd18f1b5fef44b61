"""repro.metrics — unified I/O telemetry + contention emulation.

- :class:`LatencyHistogram` — fixed log-bucket histograms, p50/p95/p99
- :class:`IOStats` — the unified stats protocol (atomic snapshot/reset,
  per-op/per-shard/per-lane breakdowns, JSON export) that the backend stats
  (``DaosStats``, ``PosixStats``) subclass
- :class:`ContentionModel` and the :class:`LustreContention` /
  :class:`DaosContention` variants — deterministic service-time injection
  parameterised by :mod:`repro.core.costmodel`, with a virtual-clock mode
"""

from .contention import (
    ClientClock,
    ContentionModel,
    DaosContention,
    LustreContention,
    make_contention,
)
from .histogram import LatencyHistogram
from .iostats import IOStats

__all__ = [
    "LatencyHistogram",
    "IOStats",
    "ClientClock",
    "ContentionModel",
    "LustreContention",
    "DaosContention",
    "make_contention",
]
