"""POSIX Catalogue backend (paper §1.3).

Write pathway (optimised to benefit writers):

- each process buffers index entries privately per (dataset, collocation);
- ``flush()`` writes them as a new **immutable index segment file**, fsyncs,
  then publishes it by appending one fixed-format record to the dataset's
  **table-of-contents (TOC)** file opened with ``O_APPEND`` — the "careful
  insertion of entries on the end of a table of contents file, making use of
  the precise semantics of the O_APPEND mode" that provides FDB
  transactionality on POSIX.

Read pathway (made *good enough* via preloading/caching/pruning):

- readers tail the TOC incrementally (cached offset), discover segments,
  and lazily load each segment with a single read (also why POSIX ``list``
  is ~2x faster than DAOS — paper §5.3);
- element lookups walk the segments of the matching collocation in reverse
  publication order, so a re-archived field transactionally supersedes the
  old one.

Every TOC tail and cross-process segment/data read is accounted as the
Lustre lock/MDS round-trips it would cost at scale (see stats.py).
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Iterable, Iterator, Mapping

from ..catalogue import Catalogue, ListEntry
from ..keys import Key, key_union
from ..schema import Schema
from ..store import FieldLocation
from .stats import POSIX_STATS, PosixStats

__all__ = ["PosixCatalogue"]

_TOC = "toc"

# Tombstone record: per-field removal publishes a normal (immutable,
# O_APPEND-TOC'd) segment whose entries carry this sentinel instead of an
# encoded location.  Newest-segment-wins then makes the removal exactly as
# transactional as a re-archive: readers that tailed the TOC past the
# tombstone see the field gone, earlier readers still resolve the old copy.
# '-' cannot prefix a real encoded location (those start with the scheme).
_TOMBSTONE = b"-"


class PosixCatalogue(Catalogue):
    def __init__(
        self,
        root: str,
        schema: Schema,
        *,
        stats: PosixStats | None = None,
        contention=None,
    ):
        super().__init__(schema)
        self._root = root
        self._stats = stats if stats is not None else POSIX_STATS
        self._cm = contention
        os.makedirs(root, exist_ok=True)
        self._mu = threading.Lock()
        self._pending: dict[tuple[str, str], dict[str, FieldLocation]] = {}
        self._seq = 0
        self._uid = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
        # reader caches
        self._toc_offset: dict[str, int] = {}
        self._toc_records: dict[str, list[tuple[str, str]]] = {}  # dataset -> [(colloc_s, segpath)]
        self._segments: dict[str, dict[str, bytes]] = {}  # segpath -> {el_s: raw location}

    @property
    def stats(self) -> PosixStats:
        return self._stats

    # --------------------------------------------------------------- writing
    def archive(self, dataset_key: Key, collocation_key: Key, element_key: Key, location: FieldLocation) -> None:
        k = (dataset_key.stringify(), collocation_key.stringify())
        with self._mu:
            self._pending.setdefault(k, {})[element_key.stringify()] = location

    def archive_batch(self, entries) -> None:
        # one mutex acquisition covers the whole batch of pending inserts
        with self._mu:
            for dataset_key, collocation_key, element_key, location in entries:
                k = (dataset_key.stringify(), collocation_key.stringify())
                self._pending.setdefault(k, {})[element_key.stringify()] = location

    def flush(self) -> None:
        self.publish_pending(self.take_pending())

    # Two-phase flush (used by FDB.flush): the caller takes the pending
    # entries BEFORE flushing the Store, then publishes them after — so a
    # concurrently archiving thread can never get an entry published whose
    # data bytes were still sitting in a write buffer when the Store flush
    # ran (the §1.3 store-before-catalogue invariant, preserved under
    # cross-thread flush stealing).

    def take_pending(self) -> dict:
        with self._mu:
            pending, self._pending = self._pending, {}
        return pending

    def publish_pending(self, pending: dict) -> None:
        for (ds_s, co_s), entries in pending.items():
            ddir = os.path.join(self._root, ds_s)
            os.makedirs(ddir, exist_ok=True)
            with self._mu:
                # concurrent flushers (AsyncFDB, shared handles) must never
                # compute the same segment name — open('wb') would truncate
                # the other flusher's already-published segment
                self._seq += 1
                seq = self._seq
            segname = f"{co_s}.{self._uid}.{seq}.index"
            segpath = os.path.join(ddir, segname)
            with open(segpath, "wb") as f:
                lat = self._cm.mds(2) if self._cm else None
                self._stats.account("create_index_segment", mds=2, seconds=lat)
                payload = b"".join(
                    el.encode()
                    + b"\t"
                    + (loc if isinstance(loc, bytes) else loc.encode())
                    + b"\n"
                    for el, loc in entries.items()
                )
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
                lat = self._cm.write(segpath, len(payload)) if self._cm else None
                self._stats.account(
                    "write_index_segment", nbytes_w=len(payload), locks=1, seconds=lat, shard=segpath
                )
            # publish: one-line record appended atomically via O_APPEND
            tocpath = os.path.join(ddir, _TOC)
            record = f"idx {co_s} {segname}\n".encode()
            fd = os.open(tocpath, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                os.write(fd, record)
                os.fsync(fd)
            finally:
                os.close(fd)
            # the TOC append is the write-lock exchange every reader contends on
            if self._cm:
                lat = self._cm.write(tocpath, len(record)) + self._cm.mds(1)
            else:
                lat = None
            self._stats.account(
                "toc_append", nbytes_w=len(record), locks=1, mds=1, seconds=lat, shard=tocpath
            )

    # --------------------------------------------------------------- reading
    # reader caches are shared across this process's threads (AsyncFDB fans
    # retrieve_batch out concurrently), so tail/load hold the mutex: a
    # racing pair of tails must not double-append records or regress the
    # cached offset

    def _tail_toc(self, ds_s: str) -> list[tuple[str, str]]:
        """Incrementally read new TOC records (cached offset per dataset)."""
        tocpath = os.path.join(self._root, ds_s, _TOC)
        with self._mu:
            records = self._toc_records.setdefault(ds_s, [])
            try:
                size = os.path.getsize(tocpath)
            except FileNotFoundError:
                return records
            off = self._toc_offset.get(ds_s, 0)
            if size > off:
                with open(tocpath, "rb") as f:
                    f.seek(off)
                    data = f.read(size - off)
                # only complete records (writer appends are record-atomic)
                consumed = data.rfind(b"\n") + 1
                for line in data[:consumed].splitlines():
                    parts = line.decode().split(" ", 2)
                    if len(parts) == 3 and parts[0] == "idx":
                        records.append((parts[1], parts[2]))
                self._toc_offset[ds_s] = off + consumed
                # tailing a TOC being appended: conflicting read lock + stat
                if self._cm:
                    lat = self._cm.read(tocpath, consumed) + self._cm.mds(1)
                else:
                    lat = None
                self._stats.account(
                    "toc_read", nbytes_r=consumed, locks=1, mds=1, seconds=lat, shard=tocpath
                )
            return records

    def _load_segment(self, ds_s: str, segname: str) -> dict[str, bytes]:
        segpath = os.path.join(self._root, ds_s, segname)
        with self._mu:
            seg = self._segments.get(segpath)
            if seg is None:
                with open(segpath, "rb") as f:
                    raw = f.read()  # single read per segment file
                if self._cm:
                    lat = self._cm.read(segpath, len(raw)) + self._cm.mds(1)
                else:
                    lat = None
                self._stats.account(
                    "read_index_segment", nbytes_r=len(raw), locks=1, mds=1, seconds=lat, shard=segpath
                )
                seg = {}
                for line in raw.splitlines():
                    el, _, loc = line.partition(b"\t")
                    seg[el.decode()] = loc
                self._segments[segpath] = seg
            return seg

    def retrieve(self, dataset_key: Key, collocation_key: Key, element_key: Key) -> FieldLocation | None:
        ds_s = dataset_key.stringify()
        co_s = collocation_key.stringify()
        el_s = element_key.stringify()
        records = self._tail_toc(ds_s)
        # reverse publication order -> newest segment wins (replacement)
        for rec_co, segname in reversed(records):
            if rec_co != co_s:
                continue
            raw = self._load_segment(ds_s, segname).get(el_s)
            if raw is not None:
                return None if raw == _TOMBSTONE else FieldLocation.decode(raw)
        return None

    def retrieve_batch(self, triples) -> list[FieldLocation | None]:
        """Batched lookup: the TOC of each distinct dataset is tailed once
        (one stat + read-lock round) and its records reused for every lookup
        of the batch, instead of one tail per retrieve."""
        out: list[FieldLocation | None] = []
        tailed: dict[str, list[tuple[str, str]]] = {}
        for dataset_key, collocation_key, element_key, in triples:
            ds_s = dataset_key.stringify()
            records = tailed.get(ds_s)
            if records is None:
                records = tailed[ds_s] = list(self._tail_toc(ds_s))
            co_s = collocation_key.stringify()
            el_s = element_key.stringify()
            found = None
            for rec_co, segname in reversed(records):
                if rec_co != co_s:
                    continue
                raw = self._load_segment(ds_s, segname).get(el_s)
                if raw is not None:
                    if raw != _TOMBSTONE:
                        found = FieldLocation.decode(raw)
                    break
            out.append(found)
        return out

    def remove_batch(self, triples) -> list[FieldLocation | None]:
        """Field-granular removal: resolve each entry's current location,
        then publish tombstone records through the normal immutable-segment
        + O_APPEND-TOC pathway — the same transactional exchange as a
        re-archive, so a concurrent reader sees the old copy or nothing,
        never a half-removed index."""
        prior = self.retrieve_batch(triples)
        pending: dict[tuple[str, str], dict[str, bytes]] = {}
        for (ds_k, co_k, el_k), loc in zip(triples, prior):
            if loc is None:
                continue
            pending.setdefault((ds_k.stringify(), co_k.stringify()), {})[
                el_k.stringify()
            ] = _TOMBSTONE
        if pending:
            self.publish_pending(pending)
        return prior

    def list(self, request: Mapping[str, Iterable[str] | str]) -> Iterator[ListEntry]:
        ds_req, co_req, el_req = self.schema.request_levels(request)
        try:
            datasets = sorted(os.listdir(self._root))
            lat = self._cm.mds(1) if self._cm else None
            self._stats.account("readdir", mds=1, seconds=lat)
        except FileNotFoundError:
            return
        for ds_s in datasets:
            if not os.path.isdir(os.path.join(self._root, ds_s)):
                continue
            try:
                dataset_key = self.schema.dataset_from_string(ds_s)
            except ValueError:
                continue
            if not dataset_key.matches(ds_req):
                continue
            emitted: set[str] = set()
            records = self._tail_toc(ds_s)
            for co_s, segname in reversed(records):
                colloc_key = self.schema.collocation_from_string(co_s)
                if not colloc_key.matches(co_req):
                    continue
                seg = self._load_segment(ds_s, segname)
                for el_s, raw in seg.items():
                    full_id = f"{co_s}/{el_s}"
                    if full_id in emitted:
                        continue  # superseded by a newer segment
                    if raw == _TOMBSTONE:
                        # removed: suppress every older copy of this element
                        emitted.add(full_id)
                        continue
                    element_key = self.schema.element_from_string(el_s)
                    if not element_key.matches(el_req):
                        continue
                    emitted.add(full_id)
                    yield ListEntry(
                        key_union(dataset_key, colloc_key, element_key), FieldLocation.decode(raw)
                    )

    def wipe(self, dataset_key: Key) -> None:
        import shutil

        ds_s = dataset_key.stringify()
        ddir = os.path.join(self._root, ds_s)
        shutil.rmtree(ddir, ignore_errors=True)
        with self._mu:
            # pending (archived-but-unflushed) entries of the wiped dataset
            # must die with it: a later flush would otherwise publish index
            # entries pointing at data files the store wipe just deleted
            for key in [key for key in self._pending if key[0] == ds_s]:
                del self._pending[key]
            self._toc_offset.pop(ds_s, None)
            self._toc_records.pop(ds_s, None)
            # cached segments of the wiped dataset must not satisfy lookups
            # for a later dataset of the same name
            prefix = ddir + os.sep
            for segpath in [p for p in self._segments if p.startswith(prefix)]:
                del self._segments[segpath]
        lat = self._cm.mds(1) if self._cm else None
        self._stats.account("wipe", mds=1, seconds=lat)
