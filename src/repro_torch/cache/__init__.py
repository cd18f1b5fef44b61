"""repro.cache — the dissemination read cache subsystem.

A :class:`CacheFDB` facade (read-through, consistent-hash sharded,
single-flight coalescing, write-path invalidation) over any
:class:`~repro.core.FDBClient`, declaratively composable as
``{"type": "cache", "max_bytes": ..., "inner": {...}}`` in
:func:`~repro.core.config.build_fdb`.  See :mod:`repro.cache.fdb` for the
design notes.
"""

from .fdb import CacheFDB
from .shard import CacheShard, HashRing, ShardedCache
from .singleflight import Flight, SingleFlight

__all__ = [
    "CacheFDB",
    "CacheShard",
    "Flight",
    "HashRing",
    "ShardedCache",
    "SingleFlight",
]
