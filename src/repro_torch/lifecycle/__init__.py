"""repro.lifecycle — online data-lifecycle management over tiered FDBs.

The paper's deployment is a hot NVM tier (DAOS) absorbing the forecast
write burst in front of a cold parallel-filesystem archive ("DAOS as HPC
Storage, a view from NWP" describes the same hot/cold object lifecycle at
ECMWF).  :class:`~repro.core.SelectFDB` expresses that placement in config,
but statically — this package makes the data actually MOVE:

- :class:`LifecyclePolicy` — declarative demotion/promotion rules over
  field age (virtual or wall clock), MARS metadata fragments (``step``
  ranges), and access counts;
- :class:`LifecycleFDB` — a pass-through facade that observes archives and
  accesses, and runs the migration engine: batched ``retrieve_batch ->
  archive_batch -> remove`` between tiers with a pin/copy/flip/remove
  protocol over the SelectFDB placement overlay, so a concurrent reader
  always resolves *exactly one* authoritative copy;
- ``{"type": "lifecycle", "policies": [...], "inner": <select>}`` as a
  :func:`~repro.core.config.build_fdb` node, composing under AsyncFDB and
  CacheFDB (migrations invalidate cache entries for moved keys).

`fdb_hammer --churn` measures what this costs: foreground bandwidth with
and without the migrator competing for the same (modelled) storage.
"""

from .engine import LifecycleFDB, MigrationReport
from .policy import LifecyclePolicy

__all__ = ["LifecycleFDB", "LifecyclePolicy", "MigrationReport"]
