"""The FDB facade — the paper's external, metadata-driven API (§1.3).

Composes any conforming (Catalogue, Store) backend pair and guarantees:

1. data is either visible and correctly indexed, or not (ACID);
2. ``archive()`` blocks until the FDB has taken control of the data
   (visibility is permitted but not required at this point);
3. ``flush()`` blocks until everything archived by this process is
   persisted, indexed and visible to any reader via retrieve()/list();
4. once visible, data is immutable;
5. re-archiving the same identifier transactionally replaces it — the old
   data stays visible until the new is fully persisted and indexed.

The one ordering invariant the facade enforces: within ``archive()`` the
Store archives *before* the Catalogue indexes, and within ``flush()`` the
Store flushes *before* the Catalogue publishes — so an index entry can never
point at unpersisted bytes, on either backend.  Symmetrically, ``wipe()``
removes the index FIRST, then the store objects, so the index never points
at deleted bytes either.

The client surface (single/batched/MARS-style IO, validated list, wipe
reports, telemetry) comes from :class:`~repro.core.client.FDBClient`; this
class provides only the catalogue/store composition.
"""

from __future__ import annotations

import threading
from typing import Iterator, Mapping, Sequence

from .catalogue import Catalogue, ListEntry
from .client import FDBClient, WipeReport
from .datahandle import DataHandle
from .keys import Key
from .request import Request
from .schema import Schema, SplitKey
from .store import Store

__all__ = ["FDB", "make_fdb"]


class FDB(FDBClient):
    def __init__(self, catalogue: Catalogue, store: Store):
        if catalogue.schema is None:
            raise ValueError("catalogue must carry a schema")
        self.catalogue = catalogue
        self.store = store
        self.schema: Schema = catalogue.schema
        # serialises flush(): a racing flush must not return before entries
        # it observed as archived are published (see flush below)
        self._flush_mu = threading.Lock()

    # ------------------------------------------------------------------ write
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        tr = self._trace
        with tr.span("fdb.archive"):
            split = self._split(key)
            with tr.span("store.archive") as sp:
                if tr.enabled:
                    sp.set("bytes", len(data))
                location = self.store.archive(
                    bytes(data), split.dataset, split.collocation
                )
            with tr.span("catalogue.archive"):
                self.catalogue.archive(
                    split.dataset, split.collocation, split.element, location
                )

    def archive_batch(self, items: Sequence[tuple[Key | Mapping[str, str], bytes]]) -> None:
        """Archive many (key, data) pairs in one backend round.

        Equivalent to sequential ``archive`` calls but the per-call costs
        (locks, OID allocation, completion waits) are amortised across the
        batch.  The ordering invariant holds batch-wide: the Store archives
        the WHOLE batch before the Catalogue indexes any of it."""
        tr = self._trace
        with tr.span("fdb.archive_batch") as sp:
            splits = [self._split(key) for key, _ in items]
            if tr.enabled:
                sp.set("n_items", len(splits))
                sp.set("bytes", sum(len(d) for _, d in items))
            with tr.span("store.archive_batch"):
                locations = self.store.archive_batch(
                    [
                        (bytes(data), s.dataset, s.collocation)
                        for (_, data), s in zip(items, splits)
                    ]
                )
            with tr.span("catalogue.archive_batch"):
                self.catalogue.archive_batch(
                    [
                        (s.dataset, s.collocation, s.element, loc)
                        for s, loc in zip(splits, locations)
                    ]
                )

    def _split(self, key: Key | Mapping[str, str]) -> SplitKey:
        return self.schema.split(self._as_key(key))

    def flush(self) -> None:
        # Two-phase when the catalogue supports it: TAKE the pending index
        # entries first, flush the Store, then publish exactly what was
        # taken.  With concurrent archivers, flushing the store first and
        # taking after would publish entries whose bytes arrived in a write
        # buffer AFTER the store flush ran — an index entry must never point
        # at unpersisted data (§1.3).  The lock makes a racing flush() block
        # until entries it observed are published, not return early empty-
        # handed because another flusher took them.
        take = getattr(self.catalogue, "take_pending", None)
        tr = self._trace
        with self._flush_mu, tr.span("fdb.flush"):
            if take is not None:
                pending = take()
                with tr.span("store.flush"):
                    self.store.flush()   # data durable first …
                with tr.span("catalogue.publish"):
                    self.catalogue.publish_pending(pending)  # … then publish
            else:
                with tr.span("store.flush"):
                    self.store.flush()
                with tr.span("catalogue.flush"):
                    self.catalogue.flush()

    # ------------------------------------------------------------------- read
    def retrieve(self, key: Key | Mapping[str, str]) -> DataHandle | None:
        split = self._split(key)
        location = self.catalogue.retrieve(split.dataset, split.collocation, split.element)
        if location is None:
            return None  # not an error: FDB may be a cache in a larger system
        return self.store.retrieve(location)

    def retrieve_batch(self, keys: Sequence[Key | Mapping[str, str]]) -> list[DataHandle | None]:
        """Vectored ``retrieve``: one Catalogue batch lookup, one Store batch
        open.  Absent fields come back as None."""
        tr = self._trace
        with tr.span("fdb.retrieve_batch") as sp:
            splits = [self._split(k) for k in keys]
            if tr.enabled:
                sp.set("n_keys", len(splits))
            with tr.span("catalogue.retrieve_batch"):
                locations = self.catalogue.retrieve_batch(
                    [(s.dataset, s.collocation, s.element) for s in splits]
                )
            with tr.span("store.retrieve_batch"):
                return self.store.retrieve_batch(locations)

    def _list(self, request: Request) -> Iterator[ListEntry]:
        return self.catalogue.list(request)

    # ------------------------------------------------------------------- wipe
    def _remove_fields(self, keys) -> int:
        """Field-granular removal, index-first like the dataset wipe: the
        catalogue entry goes (transactionally — tombstone segment on POSIX,
        MVCC ``kv_remove`` on DAOS), THEN the store bytes are punched, so a
        reader either resolves nothing or resolves a location whose bytes
        may at worst vanish into the :class:`FieldGoneError` → re-resolve
        path — never a torn read."""
        tr = self._trace
        splits = [self._split(k) for k in keys]
        with tr.span("catalogue.remove") as sp:
            prior = self.catalogue.remove_batch(
                [(s.dataset, s.collocation, s.element) for s in splits]
            )
            if tr.enabled:
                sp.set("n_keys", len(splits))
        removed = 0
        with tr.span("store.punch"):
            for loc in prior:
                if loc is not None:
                    removed += 1
                    self.store.punch(loc)
        return removed

    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        """Remove one dataset everywhere: count what the index holds, drop
        the index, then drop the store objects — index-first, so no reader
        can hold an index entry pointing at already-deleted bytes."""
        tr = self._trace
        if entries is None:
            entries = list(self.catalogue.list(Request(dataset_key)))
        indexed_bytes = sum(e.location.length for e in entries)
        with tr.span("catalogue.wipe"):
            self.catalogue.wipe(dataset_key)
        # the store reports the bytes it physically reclaimed itself; on
        # layouts where the catalogue's dataset-directory/container removal
        # already took the data with it, that is 0 and the indexed byte
        # count stands in
        with tr.span("store.wipe"):
            store_bytes = self.store.wipe(dataset_key) or 0
        # report.datasets means "what was actually wiped": an exact
        # multi-value span may name datasets that never existed — those
        # no-op wipes must not be listed
        existed = bool(entries) or store_bytes > 0
        return WipeReport(
            entries_removed=len(entries),
            bytes_freed=max(indexed_bytes, store_bytes),
            datasets=(dataset_key.stringify(),) if existed else (),
        )

    # ------------------------------------------------------------- telemetry
    def io_stats(self) -> list:
        """The distinct :class:`~repro.metrics.IOStats` instances behind this
        FDB (store + catalogue; deduplicated — the DAOS pair shares the
        engine's, a POSIX pair may share the process-global one)."""
        seen: dict[int, object] = {}
        for part in (self.store, self.catalogue):
            s = getattr(part, "stats", None)
            if s is not None:
                seen.setdefault(id(s), s)
        # the codec sink (effective-vs-wire bytes) rides along when this
        # client ever packed/unpacked fields
        return list(seen.values()) + self._codec_sinks()

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.flush()
        self.store.close()
        self.catalogue.close()


def make_fdb(
    backend: str,
    *,
    schema: Schema,
    root: str | None = None,
    engine=None,
    pool: str = "fdb",
    stats=None,
    contention=None,
    **kw,
) -> FDB:
    """Single-pair factory — a thin shim over the declarative config layer
    (:func:`repro.core.config.build_fdb`); ``backend`` is any registered
    backend name (``'posix'``/``'daos'`` register themselves).

    posix: ``root`` directory required; ``stats``/``contention`` reach the
    store + catalogue (default: process-global ``POSIX_STATS``, no model).
    daos: ``engine`` (DaosEngine or DaosClient) required; a ``contention``
    model is attached to an engine that has none — an engine that already
    carries a DIFFERENT model raises instead of being silently rewired.
    """
    from .config import build_fdb

    if backend == "posix" and stats is None:
        # keep this factory's documented default: config-built tiers get a
        # fresh per-tier sink, make_fdb keeps the process-global one
        from .posix import POSIX_STATS

        stats = POSIX_STATS
    cfg: dict = {"type": "local", "backend": backend, "schema": schema, **kw}
    if root is not None:
        cfg["root"] = root
    if engine is not None:
        cfg["engine"] = engine
    if stats is not None:
        cfg["stats"] = stats
    if contention is not None:
        cfg["contention"] = contention
    if backend == "daos":
        cfg.setdefault("pool", pool)
    fdb = build_fdb(cfg)
    assert isinstance(fdb, FDB)
    return fdb
