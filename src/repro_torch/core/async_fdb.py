"""AsyncFDB — the concurrency facade over any FDB-like object.

The paper attributes most of DAOS's win under contention to keeping many
small I/Os in flight while POSIX round-trips one lock at a time; the
synchronous :class:`~repro.core.fdb.FDB` cannot express that from a single
client.  AsyncFDB adds it without changing the semantics:

- ``archive()`` enqueues and returns immediately; a bounded pool of
  background writer threads drains the queue in batches through
  ``FDB.archive_batch`` (so the backends' amortised paths are exercised);
- ``flush()`` is a barrier: it blocks until every field archived by this
  process has been handed to the backend, THEN flushes the underlying FDB —
  store before catalogue, so the ordering invariant of §1.3 is preserved
  end-to-end and an index entry can never point at unpersisted bytes;
- ``drain()`` is the write barrier alone (all queued archives landed in the
  backend, nothing published yet on deferred-visibility backends) — the
  checkpoint manager uses it to order its commit sentinel;
- ``retrieve_many()`` expands a MARS-style request (full OR partial) and
  fans the reads out over a thread pool in batches — the returned
  :class:`~repro.core.fieldset.FieldSet` resolves through parallel batched
  reads.

Writer errors are captured and re-raised on the next ``archive()``/
``flush()``/``close()`` — an async archive is not allowed to fail silently.

Each writer thread owns a hash-partitioned queue: every identifier always
lands on the same writer, so re-archives of one key stay FIFO and the
facade keeps FDB's transactional last-write-wins replacement semantics.
(Cross-key ordering is not promised — FDB never promised it either.)

Composes with :class:`~repro.core.router.FDBRouter` in either order: an
AsyncFDB over a router gives one queue feeding N lanes; a router over
AsyncFDB lanes gives a queue per lane.  The shared client surface comes
from :class:`~repro.core.client.FDBClient`; this class adds only the
queueing and fan-out.
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Mapping, Sequence

from ..metrics.iostats import IOStats
from .catalogue import ListEntry
from .client import FDBClient, WipeReport
from .datahandle import DataHandle
from .keys import Key
from .request import Request
from .schema import Schema

__all__ = ["AsyncFDB"]

_STOP = object()


def _writer_lane(key: Key) -> int:
    """Stable writer partition for an identifier: a crc32 of the SORTED
    ``k=v`` items (same digest family as FDBRouter's lane hashing).  The
    built-in ``hash()`` is PYTHONHASHSEED-randomized, which made queue
    assignment — and the per-writer telemetry — differ run to run and
    process to process; and Key equality is order-insensitive while
    ``canonical()`` preserves insertion order, so sorting is what makes
    equal keys land on the same writer (FIFO last-write-wins depends on
    it)."""
    canon = ",".join(f"{k}={v}" for k, v in sorted(key.items()))
    return zlib.crc32(canon.encode("utf-8"))


class AsyncFDB(FDBClient):
    def __init__(
        self,
        fdb,
        *,
        writers: int = 4,
        batch_size: int = 32,
        queue_depth: int = 1024,
        readers: int = 8,
        read_batch_size: int = 32,
        owns_fdb: bool = False,
    ):
        if writers < 1:
            raise ValueError("need at least one writer thread")
        self.fdb = fdb
        self.schema: Schema = fdb.schema
        # the codec pack width is the WRAPPED client's choice (a CodecFDB
        # tier fixes it declaratively) — archive_fields packs up front on
        # the caller's thread, so the width must ride through this facade
        self._codec_nbits = getattr(fdb, "_codec_nbits", type(self)._codec_nbits)
        self._batch_size = max(1, batch_size)
        self._read_batch_size = max(1, read_batch_size)
        self._readers = max(1, readers)
        self._owns_fdb = owns_fdb
        #: facade-level telemetry: queue wait (enqueue -> backend hand-off),
        #: per-batch landing time, coalesced batch sizes
        self.async_stats = IOStats("async")
        # one queue per writer, identifiers hash-partitioned across them:
        # a key's archives are FIFO through its single writer (last-write-
        # wins survives), while distinct keys still fill every lane
        self._qs: list[queue.Queue] = [queue.Queue(maxsize=queue_depth) for _ in range(writers)]
        self._errors: list[Exception] = []
        self._err_mu = threading.Lock()
        self._closed = False
        self._pool: ThreadPoolExecutor | None = None
        self._pool_mu = threading.Lock()
        self._threads = [
            threading.Thread(target=self._writer_loop, args=(q,), name=f"fdb-writer-{i}", daemon=True)
            for i, q in enumerate(self._qs)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ writer pool
    def _archive_batch_now(self, batch) -> None:
        """Hand one coalesced batch to the backend; errors are captured for
        the caller-facing methods, telemetry recorded either way.

        The execution span cannot be a CHILD of the enqueue spans — they
        closed before this writer thread picked the items up — so it LINKS
        (follows-from) to the first enqueue context instead, sharing its
        trace id: queue-wait becomes a first-class, visible gap between the
        enqueue span and the linked execution span."""
        tr = self._trace
        link = None
        if tr.enabled:
            for _, _, _, ctx in batch:
                if ctx is not None:
                    link = ctx
                    break
        t0 = time.perf_counter()
        sp = tr.span("async.archive_batch", parent=None, link=link)
        with sp:
            if tr.enabled:
                sp.set("n_fields", len(batch))
                sp.set(
                    "queue_wait_max_s",
                    max(t0 - t_enq for _, _, t_enq, _ in batch),
                )
                links = [c.span_id for _, _, _, c in batch if c is not None]
                if links:
                    sp.set("enqueue_spans", links)
            try:
                self.fdb.archive_batch([(key, data) for key, data, _, _ in batch])
            except Exception as e:  # noqa: BLE001 — surfaced on archive/flush
                with self._err_mu:
                    self._errors.append(e)
            finally:
                dt = time.perf_counter() - t0
                # facade-level telemetry only: payload bytes are NOT accounted
                # here — the backend store already counts them, and a merged
                # stats_snapshot() must not double-count (nor count bytes for
                # a batch whose backend call failed)
                records = [
                    ("async_queue_wait", {"seconds": t0 - t_enq})
                    for _, _, t_enq, _ in batch
                ]
                records.append(("async_archive_batch", {"seconds": dt}))
                records.append(("async_batch_fields", {"count": len(batch)}))
                self.async_stats.record_burst(records)

    def _writer_loop(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is _STOP:
                q.task_done()
                return
            batch = [item]
            # greedy drain: coalesce whatever is already queued into one
            # backend round, up to the batch size
            while len(batch) < self._batch_size:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    # keep the sentinel last: finish this batch, then exit
                    try:
                        self._archive_batch_now(batch)
                    finally:
                        for _ in batch:
                            q.task_done()
                        q.task_done()  # the sentinel itself
                    return
                batch.append(nxt)
            try:
                self._archive_batch_now(batch)
            finally:
                for _ in batch:
                    q.task_done()

    def _raise_pending(self) -> None:
        """Drain EVERY captured writer error and raise the first, with the
        rest attached as its ``__context__`` chain — concurrent batches can
        fail independently, and all but one silently vanishing would hide
        real data loss from the caller."""
        with self._err_mu:
            if not self._errors:
                return
            errors, self._errors = self._errors, []
        first, rest = errors[0], errors[1:]
        tail = first
        for e in rest:
            # walk to the end of the existing chain before appending, so
            # repeated failures never drop or cycle earlier context
            while tail.__context__ is not None:
                tail = tail.__context__
            tail.__context__ = e
            tail = e
        raise first

    # ------------------------------------------------------------------ write
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        """Hand the field to the background pool (blocks only when the
        bounded queue is full — backpressure, not unbounded memory)."""
        if self._closed:
            raise RuntimeError("archive() on a closed AsyncFDB")
        self._raise_pending()
        tr = self._trace
        with tr.span("async.enqueue") as sp:
            key = self._as_key(key)
            self.schema.validate(key)  # fail fast, in the caller, not the pool
            # the enqueue span's context rides in the queue item so the
            # writer-lane execution span can link back to it (sp.context is
            # None on the null span — no allocation when tracing is off)
            self._qs[_writer_lane(key) % len(self._qs)].put(
                (key, bytes(data), time.perf_counter(), sp.context)
            )

    def drain(self) -> None:
        """Write barrier: block until every queued field has been archived
        into the backend (visible on immediate-visibility backends, pending
        publish on deferred ones).  Does NOT flush the underlying FDB."""
        tr = self._trace
        with tr.span("async.drain"):
            for q in self._qs:
                q.join()
        self._raise_pending()

    def flush(self) -> None:
        """Full barrier + publish: all queued archives land in the Store and
        Catalogue first, then the underlying flush runs store-before-
        catalogue — the §1.3 invariant, preserved under async writes."""
        self.drain()
        self.fdb.flush()

    # ------------------------------------------------------------------- read
    def _read_pool(self) -> ThreadPoolExecutor:
        with self._pool_mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._readers, thread_name_prefix="fdb-reader"
                )
            return self._pool

    def retrieve(self, key: Key | Mapping[str, str]) -> DataHandle | None:
        return self.fdb.retrieve(key)

    def retrieve_batch(self, keys: Sequence[Key | Mapping[str, str]]) -> list[DataHandle | None]:
        return self.fdb.retrieve_batch(keys)

    def _traced_chunk(self, method, chunk, ctx):
        """Run one read chunk on a pool thread, parented under the caller's
        fan-out span (explicit cross-thread parent: the fan-out span stays
        open until every future resolves, so containment holds)."""
        with self._trace.span("async.read_chunk", parent=ctx) as sp:
            if self._trace.enabled:
                sp.set("n_keys", len(chunk))
            return method(chunk)

    def _fan_out(self, keys: list, method) -> list:
        tr = self._trace
        with tr.span("async.fan_out") as sp:
            chunks = [
                keys[i : i + self._read_batch_size]
                for i in range(0, len(keys), self._read_batch_size)
            ]
            if len(chunks) <= 1:
                return method(list(keys))
            if tr.enabled:
                sp.set("n_keys", len(keys))
                sp.set("n_chunks", len(chunks))
            ctx = sp.context
            pool = self._read_pool()
            futures = [
                pool.submit(self._traced_chunk, method, c, ctx) for c in chunks
            ]
            out: list = []
            for f in futures:
                out.extend(f.result())
            return out

    # a FieldSet from retrieve_many resolves in ONE fetch (batch_size=None),
    # and that fetch is the parallel chunked fan-out over the reader pool
    _fieldset_batch = None

    def _many_fetch(self, keys: list[Key]) -> list[DataHandle | None]:
        return self._fan_out(keys, self.fdb.retrieve_batch)

    # ------------------------------------------------------------- pass-through
    @property
    def store(self):
        return self.fdb.store

    @property
    def catalogue(self):
        return self.fdb.catalogue

    def _list(self, request: Request) -> Iterator[ListEntry]:
        # already validated by the base — skip the inner client's re-check
        return getattr(self.fdb, "_list", self.fdb.list)(request)

    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        # the base wipe() already flushed (drain + publish); this extra
        # drain covers routers calling straight into lane._wipe_dataset
        self.drain()
        return self.fdb._wipe_dataset(dataset_key, entries)

    # ------------------------------------------------------------- telemetry
    def io_stats(self) -> list:
        """Backend stats plus this facade's queue/batch telemetry (and the
        codec sink, when this facade ever packed fields)."""
        getter = getattr(self.fdb, "io_stats", None)
        below = list(getter()) if getter is not None else []
        return below + [self.async_stats] + self._codec_sinks()

    # ---------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # a failed flush must NOT leave the pool half-open: stop the writer
        # threads and reader pool unconditionally, re-raise at the end
        flush_err: Exception | None = None
        try:
            self.flush()
        except Exception as e:  # noqa: BLE001
            flush_err = e
        for q in self._qs:
            q.put(_STOP)
        for t in self._threads:
            t.join(timeout=30)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if self._owns_fdb:
            self.fdb.close()
        if flush_err is not None:
            raise flush_err
        self._raise_pending()
