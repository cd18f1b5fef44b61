"""Functional emulation of the libdaos subset used by the paper.

The paper's FDB backends use (paper §2/§3):

- pools and containers (``daos_pool_connect``, ``daos_cont_create/open``),
- the high-level Key-Value API (``daos_kv_put``, ``daos_kv_get``, key listing),
- the Array API (``daos_array_create/open_with_attrs/write/read/get_size``),
- batched OID allocation (``daos_cont_alloc_oids``),
- object classes (OC_S1 unstriped / OC_SX striped).

The emulation reproduces the *semantics* the paper leans on:

- **MVCC, lockless, server-side contention resolution**: every write lands
  in a new immutable region/version and is then atomically indexed; readers
  never block writers and always observe the latest fully-written version
  (paper §2, "Multiversion Concurrency Control").
- **Immediate visibility**: once a put/write returns, the data is visible to
  every other client — which is why the DAOS backends' ``flush()`` is a
  no-op (paper §3.1.2/§3.2.2).
- **Metadata distributed across all engines** (no dedicated MDS): emulated by
  hashing dkeys over targets and accounting per-target ops, consumed by the
  benchmark cost model.

Two runtimes share this module: the in-process thread-safe engine (framework
use) and a socket-served engine for true multi-process contention tests
(:mod:`repro.core.daos.server`).
"""

from .engine import DaosEngine, DaosError, ENOENT, EEXIST
from .objects import OC_S1, OC_SX, ArrayObject, KVObject, ObjectId
from .pool import Container, Pool

__all__ = [
    "DaosEngine",
    "DaosError",
    "ENOENT",
    "EEXIST",
    "Pool",
    "Container",
    "KVObject",
    "ArrayObject",
    "ObjectId",
    "OC_S1",
    "OC_SX",
]
