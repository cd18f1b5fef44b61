"""DAOS Store backend (paper §3.1.2).

- one container per stringified *dataset* key (collocation key intentionally
  unused for placement: separate collocation containers were tried and
  removed for performance — paper §3.1.2);
- one DAOS **Array object per field**, OID drawn from a client-cached
  pre-allocated range (avoids a server round-trip per create);
- arrays opened with ``daos_array_open_with_attrs`` (write-path optimisation
  listed in paper §5.3);
- data immediately persisted and visible -> ``flush()`` is a **no-op**;
- the returned location encodes length+offset so reads never call
  ``daos_array_get_size`` (read-path optimisation, §5.3).
"""

from __future__ import annotations

import threading

from ..datahandle import DataHandle, FieldGoneError
from ..keys import Key
from ..store import FieldLocation, Store
from ..daos.engine import ENOENT, DaosError
from ..daos.objects import OC_S1, ObjectId

__all__ = ["DaosStore", "OidAllocator"]


class OidAllocator:
    """Client-side cache of a pre-allocated contiguous OID range."""

    def __init__(self, engine, pool: str, cont: str, batch: int = 256):
        self._engine = engine
        self._pool = pool
        self._cont = cont
        self._batch = batch
        self._next = 0
        self._limit = 0
        self._mu = threading.Lock()

    def next_oid(self) -> ObjectId:
        return self.next_oids(1)[0]

    def next_oids(self, n: int) -> list[ObjectId]:
        """Draw *n* OIDs at once — at most ONE server allocation round-trip
        amortised over the whole batch (vs. up to n with per-field draws)."""
        out: list[ObjectId] = []
        with self._mu:
            take = min(n, self._limit - self._next)
            out.extend(ObjectId(1, self._next + i) for i in range(take))
            self._next += take
            short = n - take
            if short:
                # one allocation sized for the shortfall but no smaller than
                # the configured batch, so steady state stays one RPC per
                # many batches
                count = max(self._batch, short)
                base = self._engine.cont_alloc_oids(self._pool, self._cont, count)
                out.extend(ObjectId(1, base + i) for i in range(short))
                self._next = base + short
                self._limit = base + count
        return out  # hi=1: data arrays (hi=0 reserved for index KVs)


class DaosStore(Store):
    scheme = "daos"

    def __init__(self, engine, pool: str = "fdb", *, oid_batch: int = 256, oclass: str = OC_S1):
        self._engine = engine
        self._pool = pool
        self._oclass = oclass
        self._oid_batch = oid_batch
        # handle caches, kept for the process lifetime (paper §3.1.2)
        self._containers: set[str] = set()
        self._allocators: dict[str, OidAllocator] = {}
        self._mu = threading.Lock()
        engine.create_pool(pool, exist_ok=True)

    @property
    def stats(self):
        """The engine's :class:`DaosStats` (shared telemetry sink)."""
        return self._engine.stats

    # ------------------------------------------------------------------ util
    def _ensure_container(self, name: str) -> None:
        if name in self._containers:
            return
        with self._mu:
            if name in self._containers:
                return
            self._engine.cont_create(self._pool, name, exist_ok=True)
            self._containers.add(name)

    def _allocator(self, cont: str) -> OidAllocator:
        alloc = self._allocators.get(cont)
        if alloc is None:
            with self._mu:
                alloc = self._allocators.get(cont)
                if alloc is None:
                    alloc = OidAllocator(self._engine, self._pool, cont, self._oid_batch)
                    self._allocators[cont] = alloc
        return alloc

    # ------------------------------------------------------------- Store API
    def archive(self, data: bytes, dataset_key: Key, collocation_key: Key) -> FieldLocation:
        cont = dataset_key.stringify()
        self._ensure_container(cont)
        oid = self._allocator(cont).next_oid()
        # open-with-attrs creates without the attribute round trip
        self._engine.array_open_with_attrs(self._pool, cont, oid, oclass=self._oclass)
        self._engine.array_write(self._pool, cont, oid, 0, bytes(data))
        # offset always zero: one Array per field (paper §3.1.2)
        return FieldLocation(self.scheme, f"{self._pool}/{cont}/{oid}", 0, len(data))

    def archive_batch(self, items) -> list[FieldLocation]:
        """Batched archive: OID allocation is amortised across the batch
        (one ``cont_alloc_oids`` round at most per container) and the writes
        go out as ONE burst of non-blocking opens+writes completed by a
        single event-queue drain, instead of two client rounds per field."""
        groups: dict[str, list[int]] = {}
        for i, (_, dataset_key, _) in enumerate(items):
            groups.setdefault(dataset_key.stringify(), []).append(i)
        out: list[FieldLocation | None] = [None] * len(items)
        for cont, idxs in groups.items():
            self._ensure_container(cont)
            oids = self._allocator(cont).next_oids(len(idxs))
            writes = []
            for i, oid in zip(idxs, oids):
                data = bytes(items[i][0])
                writes.append((oid, 0, data))
                out[i] = FieldLocation(self.scheme, f"{self._pool}/{cont}/{oid}", 0, len(data))
            self._engine.array_write_multi(self._pool, cont, writes, oclass=self._oclass)
        return out  # type: ignore[return-value]

    def flush(self) -> None:
        # DAOS persists and publishes at archive() time — nothing to do.
        # (Would block on in-flight non-blocking ops if those were used.)
        return

    def retrieve(self, location: FieldLocation) -> DataHandle:
        if location.scheme != self.scheme:
            raise ValueError(f"not a daos location: {location}")
        return _DaosArrayHandle(self._engine, location)

    def wipe(self, dataset_key: Key) -> None:
        """Destroy the dataset's data container (covering the case where the
        store's pool differs from the catalogue's, whose own wipe only
        destroys *its* container) and drop the cached container/OID-range
        state — stale caches would make a re-archive into the wiped dataset
        skip ``cont_create`` and fail on a destroyed container.  Byte count
        is unknown at this layer (the container is gone wholesale), so the
        FDB reports the indexed byte total instead."""
        cont = dataset_key.stringify()
        self._engine.cont_destroy(self._pool, cont)  # missing_ok server-side
        with self._mu:
            self._containers.discard(cont)
            self._allocators.pop(cont, None)
        return None

    def punch(self, location: FieldLocation) -> int:
        """Field-granular reclaim: every field is its own array object, so
        ``daos_obj_punch`` frees exactly its extents — the NVM advantage the
        lifecycle migrator leans on (POSIX gets its space back only at
        dataset wipe)."""
        pool, cont, oid_s = location.uri.split("/")
        existed = self._engine.obj_punch(pool, cont, ObjectId.parse(oid_s))
        return location.length if existed else 0


class _DaosArrayHandle(DataHandle):
    def __init__(self, engine, location: FieldLocation):
        pool, cont, oid_s = location.uri.split("/")
        self._engine = engine
        self._pool = pool
        self._cont = cont
        self._oid = ObjectId.parse(oid_s)
        self._offset = location.offset
        self._length = location.length

    def read(self) -> bytes:
        return self.read_range(0, self._length)

    def read_range(self, offset: int, length: int) -> bytes:
        if offset + length > self._length:
            raise ValueError("read_range beyond field extent")
        try:
            return self._engine.array_read(
                self._pool, self._cont, self._oid, self._offset + offset, length
            )
        except DaosError as e:
            if e.errno == ENOENT:
                # container destroyed (wipe) or object punched (migration
                # source-removal) after the catalogue resolved this handle
                raise FieldGoneError(f"{self._pool}/{self._cont}/{self._oid}") from None
            raise

    @property
    def size(self) -> int:
        return self._length
