"""DAOS Catalogue backend (paper §3.2.2).

Index topology — a navigable network of Key-Value objects:

    root container, root KV @ OID 0.0
        stringified dataset key -> dataset container name
    dataset container, dataset KV @ OID 0.0
        stringified collocation key -> index KV OID (within same container)
    index KV
        stringified element key -> encoded FieldLocation
    axis KVs (one per element keyword, per index KV)
        value -> ""            (the set of values written at that level)

Properties the paper relies on:

- transactional ``daos_kv_put``/``get`` make the index consistent under
  archive/retrieve contention, resolved server-side (MVCC);
- data is visible as soon as archive() returns -> ``flush()`` is a no-op;
- per-dataset containers make dataset wipe cheap (rolling archive);
- pool/container/KV handles and reader-path root/dataset entries are cached
  for the process lifetime, so index KVs remain the only contended objects;
- ``list()`` consults axis KVs to prune, then must ``daos_kv_get`` every
  matching element entry — the reason listing is ~2x slower than POSIX
  (paper §5.3), faithfully reproduced here.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator, Mapping

from ..catalogue import Catalogue, ListEntry
from ..keys import Key, key_union
from ..schema import Schema
from ..store import FieldLocation
from ..daos.objects import ObjectId, ROOT_OID

__all__ = ["DaosCatalogue"]

_AXIS_OID_BASE = 1 << 40  # axis KV oids: hi=0, lo = base + index_lo * 64 + axis_pos


class DaosCatalogue(Catalogue):
    def __init__(self, engine, schema: Schema, pool: str = "fdb", root_container: str = "fdb_root"):
        super().__init__(schema)
        self._engine = engine
        self._pool = pool
        self._root = root_container
        engine.create_pool(pool, exist_ok=True)
        engine.cont_create(pool, root_container, exist_ok=True)
        self._mu = threading.Lock()
        # process-lifetime caches (paper §3.2.2)
        self._dataset_cache: dict[str, str] = {}  # dataset str -> container
        self._index_cache: dict[tuple[str, str], ObjectId] = {}  # (cont, colloc str) -> index oid
        self._axis_cache: dict[tuple[str, str, str], set[str]] = {}  # (cont, index, kw) -> values

    @property
    def stats(self):
        """The engine's :class:`DaosStats` (shared telemetry sink)."""
        return self._engine.stats

    # ------------------------------------------------------------------ util
    # _mu serialises resolution + cache fill across THIS process's threads
    # (the AsyncFDB writer pool drives archive_batch concurrently); racing
    # writers in OTHER processes are converged by the publish-then-re-read
    # dance below, resolved server-side by the engine's MVCC.

    def _dataset_container(self, dataset_s: str, *, create: bool) -> str | None:
        with self._mu:
            cont = self._dataset_cache.get(dataset_s)
            if cont is not None:
                return cont
            raw = self._engine.kv_get(self._pool, self._root, ROOT_OID, dataset_s)
            if raw is not None:
                cont = raw.decode()
            elif create:
                cont = dataset_s  # same name as used by the Store backend
                self._engine.cont_create(self._pool, cont, exist_ok=True)
                # ensure the dataset KV exists (OID 0.0) then publish in root KV
                self._engine.kv_put(self._pool, cont, ROOT_OID, "__dataset__", dataset_s.encode())
                self._engine.kv_put(self._pool, self._root, ROOT_OID, dataset_s, cont.encode())
            else:
                return None
            self._dataset_cache[dataset_s] = cont
            return cont

    def _index_kv(self, cont: str, colloc_s: str, *, create: bool) -> ObjectId | None:
        with self._mu:
            ck = (cont, colloc_s)
            oid = self._index_cache.get(ck)
            if oid is not None:
                return oid
            raw = self._engine.kv_get(self._pool, cont, ROOT_OID, f"idx:{colloc_s}")
            if raw is not None:
                oid = ObjectId.parse(raw.decode())
            elif create:
                base = self._engine.cont_alloc_oids(self._pool, cont, 64)
                oid = ObjectId(0, base)
                # transactional publish: last writer wins; both writers' OIDs map
                # the same collocation key, so re-read after publish to converge
                self._engine.kv_put(self._pool, cont, ROOT_OID, f"idx:{colloc_s}", str(oid).encode())
                raw2 = self._engine.kv_get(self._pool, cont, ROOT_OID, f"idx:{colloc_s}")
                oid = ObjectId.parse(raw2.decode())
            else:
                return None
            self._index_cache[ck] = oid
            return oid

    def _axis_oid(self, index_oid: ObjectId, axis_pos: int) -> ObjectId:
        return ObjectId(0, _AXIS_OID_BASE + index_oid.lo * 64 + axis_pos + 1)

    def _axis_pending(self, cont: str, index_oid: ObjectId, element_keys) -> list[tuple[int, str, str]]:
        """Axis values of *element_keys* not yet known to be stored, as
        ``(axis_pos, keyword, value)``.  The cache is only READ here; call
        :meth:`_axis_commit` once the puts succeed — a failed batch must not
        leave values cached-but-never-stored (list() would silently prune)."""
        pending: list[tuple[int, str, str]] = []
        with self._mu:
            for pos, kw in enumerate(self.schema.element_keys):
                cached = self._axis_cache.setdefault((cont, str(index_oid), kw), set())
                for val in sorted({ek[kw] for ek in element_keys} - cached):
                    pending.append((pos, kw, val))
        return pending

    def _axis_commit(self, cont: str, index_oid: ObjectId, pending) -> None:
        with self._mu:
            for _, kw, val in pending:
                self._axis_cache.setdefault((cont, str(index_oid), kw), set()).add(val)

    # ------------------------------------------------------------- Catalogue
    def archive(self, dataset_key: Key, collocation_key: Key, element_key: Key, location: FieldLocation) -> None:
        ds = dataset_key.stringify()
        co = collocation_key.stringify()
        el = element_key.stringify()
        cont = self._dataset_container(ds, create=True)
        index_oid = self._index_kv(cont, co, create=True)
        # axis KVs: record each element-keyword value for list() pruning
        pending = self._axis_pending(cont, index_oid, [element_key])
        for pos, _, val in pending:
            self._engine.kv_put(self._pool, cont, self._axis_oid(index_oid, pos), val, b"")
        # the transactional insert that publishes the field
        self._engine.kv_put(self._pool, cont, index_oid, el, location.encode())
        self._axis_commit(cont, index_oid, pending)

    def archive_batch(self, entries) -> None:
        """Batched index insert: container + index-KV resolution happens once
        per (dataset, collocation) group, axis updates are deduplicated
        across the whole batch, and every insert for a container goes out as
        ONE burst of transactional puts with a single event-queue drain."""
        groups: dict[tuple[str, str], list[tuple[Key, FieldLocation]]] = {}
        for dataset_key, collocation_key, element_key, location in entries:
            k = (dataset_key.stringify(), collocation_key.stringify())
            groups.setdefault(k, []).append((element_key, location))
        by_cont: dict[str, list[tuple[ObjectId, str, bytes]]] = {}
        commits: dict[str, list[tuple[ObjectId, list]]] = {}
        for (ds, co), group in groups.items():
            cont = self._dataset_container(ds, create=True)
            index_oid = self._index_kv(cont, co, create=True)
            puts = by_cont.setdefault(cont, [])
            # axis updates: one pass over the distinct values of the batch
            pending = self._axis_pending(cont, index_oid, [ek for ek, _ in group])
            puts.extend((self._axis_oid(index_oid, pos), val, b"") for pos, _, val in pending)
            puts.extend(
                (index_oid, element_key.stringify(), location.encode())
                for element_key, location in group
            )
            commits.setdefault(cont, []).append((index_oid, pending))
        for cont, puts in by_cont.items():
            self._engine.kv_put_multi(self._pool, cont, puts)
            for index_oid, pending in commits[cont]:
                self._axis_commit(cont, index_oid, pending)

    def flush(self) -> None:
        # archive() already persisted and published every entry (MVCC).
        return

    def retrieve(self, dataset_key: Key, collocation_key: Key, element_key: Key) -> FieldLocation | None:
        cont = self._dataset_container(dataset_key.stringify(), create=False)
        if cont is None:
            return None
        index_oid = self._index_kv(cont, collocation_key.stringify(), create=False)
        if index_oid is None:
            return None
        raw = self._engine.kv_get(self._pool, cont, index_oid, element_key.stringify())
        if raw is None:
            return None  # absence is not an error (FDB-as-cache)
        return FieldLocation.decode(raw)

    def retrieve_batch(self, triples) -> list[FieldLocation | None]:
        """Batched lookup: container and index-KV resolution is shared per
        (dataset, collocation) group; each container's burst of ``kv_get``s
        costs one event-queue drain."""
        out: list[FieldLocation | None] = [None] * len(triples)
        groups: dict[tuple[str, str], list[tuple[int, Key]]] = {}
        for i, (dataset_key, collocation_key, element_key) in enumerate(triples):
            k = (dataset_key.stringify(), collocation_key.stringify())
            groups.setdefault(k, []).append((i, element_key))
        by_cont: dict[str, list[tuple[int, ObjectId, str]]] = {}
        for (ds, co), group in groups.items():
            cont = self._dataset_container(ds, create=False)
            if cont is None:
                continue
            index_oid = self._index_kv(cont, co, create=False)
            if index_oid is None:
                continue
            by_cont.setdefault(cont, []).extend(
                (i, index_oid, element_key.stringify()) for i, element_key in group
            )
        for cont, gets in by_cont.items():
            raws = self._engine.kv_get_multi(self._pool, cont, [(oid, el) for _, oid, el in gets])
            for (i, _, _), raw in zip(gets, raws):
                if raw is not None:
                    out[i] = FieldLocation.decode(raw)
        return out

    def remove_batch(self, triples) -> list[FieldLocation | None]:
        """Field-granular removal: ``kv_remove`` each element from its index
        KV (MVCC — a concurrent reader's ``kv_get`` sees the old value or
        None, never a torn record).  Axis KVs are deliberately left alone:
        they are an over-approximating pruning hint, and a stale axis value
        only costs a futile lookup, never a wrong answer."""
        prior = self.retrieve_batch(triples)
        for (dataset_key, collocation_key, element_key), loc in zip(triples, prior):
            if loc is None:
                continue
            cont = self._dataset_container(dataset_key.stringify(), create=False)
            index_oid = self._index_kv(cont, collocation_key.stringify(), create=False)
            self._engine.kv_remove(self._pool, cont, index_oid, element_key.stringify())
        return prior

    def list(self, request: Mapping[str, Iterable[str] | str]) -> Iterator[ListEntry]:
        ds_req, co_req, el_req = self.schema.request_levels(request)
        for ds_s in self._engine.kv_list(self._pool, self._root, ROOT_OID):
            dataset_key = self.schema.dataset_from_string(ds_s)
            if not dataset_key.matches(ds_req):
                continue
            cont = self._dataset_container(ds_s, create=False)
            if cont is None:
                continue
            for entry in self._engine.kv_list(self._pool, cont, ROOT_OID):
                if not entry.startswith("idx:"):
                    continue
                co_s = entry[4:]
                colloc_key = self.schema.collocation_from_string(co_s)
                if not colloc_key.matches(co_req):
                    continue
                index_oid = self._index_kv(cont, co_s, create=False)
                if index_oid is None:
                    continue
                # axis pruning: skip this index KV if a requested element
                # value was never written into it
                if self._axis_prunes(cont, index_oid, el_req):
                    continue
                for el_s in self._engine.kv_list(self._pool, cont, index_oid):
                    element_key = self.schema.element_from_string(el_s)
                    if not element_key.matches(el_req):
                        continue
                    # every matching location costs one daos_kv_get (§5.3)
                    raw = self._engine.kv_get(self._pool, cont, index_oid, el_s)
                    if raw is None:
                        continue
                    yield ListEntry(key_union(dataset_key, colloc_key, element_key), FieldLocation.decode(raw))

    def _axis_prunes(self, cont: str, index_oid: ObjectId, el_req: Mapping[str, Iterable[str] | str]) -> bool:
        from ..request import as_span

        for pos, kw in enumerate(self.schema.element_keys):
            if kw not in el_req:
                continue
            span = as_span(el_req[kw])
            if span.is_wildcard:
                continue  # matches every written value — nothing to prune
            axis_vals = self._engine.kv_list(self._pool, cont, self._axis_oid(index_oid, pos))
            if not any(span.contains(v) for v in axis_vals):
                return True
        return False

    def wipe(self, dataset_key: Key) -> None:
        ds = dataset_key.stringify()
        # whole-container destroy — the reason datasets get their own
        # container (paper §3.2.2, rolling archive)
        self._engine.cont_destroy(self._pool, ds)
        self._engine.kv_remove(self._pool, self._root, ROOT_OID, ds)
        with self._mu:
            self._dataset_cache.pop(ds, None)
            for k in [k for k in self._index_cache if k[0] == ds]:
                del self._index_cache[k]
            for k in [k for k in self._axis_cache if k[0] == ds]:
                del self._axis_cache[k]
