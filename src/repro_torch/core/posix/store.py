"""POSIX Store backend (paper §1.3).

Each writing process streams its fields into its **own independent data
file** per dataset (no cross-process write sharing -> the write pathway runs
at the file system's limit when uncontended).  Field locations are
``(path, offset, length)``.  ``flush()`` flushes buffers + fsyncs, after
which the data bytes are durably readable by any process.

Lock accounting: writes to a private file still take one extent lock on a
real Lustre (cheap, uncontended); reads of *another process's* file take a
read lock that may conflict with the writer's cached write locks — that is
where the paper's contention collapse comes from, and the reader path here
counts those conflicting-lock acquisitions for the cost model.

Telemetry + contention: every op is accounted into a :class:`PosixStats`
(the process-global ``POSIX_STATS`` unless a per-instance one is passed),
and when a :class:`~repro.metrics.LustreContention` model is attached the
op's scale-faithful service time is injected (per-file extent-lock queue,
OST stream, MDS) and recorded in the latency histograms.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Sequence

from ..datahandle import DataHandle, FieldGoneError
from ..keys import Key
from ..store import FieldLocation, Store
from .stats import POSIX_STATS, PosixStats

__all__ = ["PosixStore"]


class PosixStore(Store):
    scheme = "posix"

    def __init__(
        self,
        root: str,
        *,
        buffer_bytes: int = 4 << 20,
        stats: PosixStats | None = None,
        contention=None,
    ):
        self._root = root
        os.makedirs(root, exist_ok=True)
        self._buffer_bytes = buffer_bytes
        self._stats = stats if stats is not None else POSIX_STATS
        self._cm = contention
        self._mu = threading.RLock()  # archive() re-enters via _data_file()
        # unique per handle: "process" identity = (pid, instance) so that
        # multiple writer handles in one OS process never collide
        self._uid = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
        # dataset str -> (fd path, file object, current offset)
        self._files: dict[str, tuple[str, object, int]] = {}
        self._seq = 0

    @property
    def stats(self) -> PosixStats:
        return self._stats

    def _data_file(self, dataset_s: str):
        ent = self._files.get(dataset_s)
        if ent is None:
            with self._mu:
                ent = self._files.get(dataset_s)
                if ent is None:
                    ddir = os.path.join(self._root, dataset_s)
                    os.makedirs(ddir, exist_ok=True)
                    self._seq += 1
                    path = os.path.join(ddir, f"{self._uid}.{self._seq}.data")
                    f = open(path, "ab", buffering=self._buffer_bytes)
                    lat = self._cm.mds(2) if self._cm else None
                    self._stats.account("open_data_file", mds=2, seconds=lat)  # create + open
                    ent = (path, f, 0)
                    self._files[dataset_s] = ent
        return ent

    def archive(self, data: bytes, dataset_key: Key, collocation_key: Key) -> FieldLocation:
        dataset_s = dataset_key.stringify()
        t0 = time.perf_counter()
        with self._mu:
            path, f, off = self._data_file(dataset_s)
            f.write(data)  # buffered append to the private stream
            self._files[dataset_s] = (path, f, off + len(data))
        # own-file extent lock (uncontended while the stream is private)
        lat = self._cm.write(path, len(data)) if self._cm else time.perf_counter() - t0
        self._stats.account("write", nbytes_w=len(data), locks=1, seconds=lat, shard=path)
        return FieldLocation(self.scheme, path, off, len(data))

    def archive_batch(self, items: Sequence[tuple[bytes, Key, Key]]) -> list[FieldLocation]:
        """Batched archive: per dataset, ONE lock acquisition covers one
        vectored write of the whole contiguous run — a single extent lock
        (and one stats record) where the sequential path pays one per field."""
        # group by dataset, preserving per-item order within each group
        groups: dict[str, list[int]] = {}
        for i, (_, dataset_key, _) in enumerate(items):
            groups.setdefault(dataset_key.stringify(), []).append(i)
        out: list[FieldLocation | None] = [None] * len(items)
        for dataset_s, idxs in groups.items():
            payloads = [bytes(items[i][0]) for i in idxs]
            t0 = time.perf_counter()
            with self._mu:
                path, f, off = self._data_file(dataset_s)
                f.write(b"".join(payloads))  # one vectored (writev-style) append
                run = off
                for i, data in zip(idxs, payloads):
                    out[i] = FieldLocation(self.scheme, path, run, len(data))
                    run += len(data)
                self._files[dataset_s] = (path, f, run)
            # one extent lock for the whole contiguous run of this batch
            lat = (
                self._cm.write(path, run - off, nfields=len(idxs))
                if self._cm
                else time.perf_counter() - t0
            )
            self._stats.account("write_batch", nbytes_w=run - off, locks=1, seconds=lat, shard=path)
        return out  # type: ignore[return-value]

    def flush(self) -> None:
        with self._mu:
            for path, f, _ in self._files.values():
                f.flush()
                os.fsync(f.fileno())
                lat = self._cm.sync() if self._cm else None
                self._stats.account("fsync", seconds=lat, shard=path)

    def retrieve(self, location: FieldLocation) -> DataHandle:
        if location.scheme != self.scheme:
            raise ValueError(f"not a posix location: {location}")
        return _PosixFileHandle(location, stats=self._stats, contention=self._cm)

    def wipe(self, dataset_key: Key) -> int:
        """Drop the dataset's write stream (a later re-archive must open a
        FRESH file, not append to a deleted inode) and remove any of its
        data files still on disk — when the store root differs from the
        catalogue root, those bytes would otherwise leak.  Returns the bytes
        physically removed here (0 when the catalogue's dataset-directory
        removal already took them)."""
        import shutil

        dataset_s = dataset_key.stringify()
        with self._mu:
            ent = self._files.pop(dataset_s, None)
            if ent is not None:
                ent[1].close()
        freed = 0
        ddir = os.path.join(self._root, dataset_s)
        if os.path.isdir(ddir):
            for name in os.listdir(ddir):
                if name.endswith(".data"):
                    try:
                        freed += os.path.getsize(os.path.join(ddir, name))
                    except OSError:
                        pass
            shutil.rmtree(ddir, ignore_errors=True)
        lat = self._cm.mds(1) if self._cm else None
        self._stats.account("wipe_store", mds=1, seconds=lat)
        return freed

    def close(self) -> None:
        self.flush()
        with self._mu:
            for _, f, _ in self._files.values():
                f.close()
            self._files.clear()


class _PosixFileHandle(DataHandle):
    def __init__(self, location: FieldLocation, *, stats: PosixStats | None = None, contention=None):
        self._path = location.uri
        self._offset = location.offset
        self._length = location.length
        self._stats = stats if stats is not None else POSIX_STATS
        self._cm = contention

    def read(self) -> bytes:
        return self.read_range(0, self._length)

    def read_range(self, offset: int, length: int) -> bytes:
        if offset + length > self._length:
            raise ValueError("read_range beyond field extent")
        t0 = time.perf_counter()
        try:
            f = open(self._path, "rb")
        except FileNotFoundError:
            # a concurrent wipe (or migration source-removal) deleted the
            # data file between catalogue resolution and this read
            raise FieldGoneError(self._path) from None
        with f:
            lat = self._cm.mds(1) if self._cm else None
            self._stats.account("open_data_file_read", mds=1, seconds=lat)
            f.seek(self._offset + offset)
            data = f.read(length)
        if len(data) < length:
            # the file exists but no longer covers this extent — same race,
            # caught mid-truncation; never hand back a torn field
            raise FieldGoneError(self._path)
        # reading another process's streamed file: conflicting extent lock
        lat = self._cm.read(self._path, len(data)) if self._cm else time.perf_counter() - t0
        self._stats.account("read", nbytes_r=len(data), locks=1, seconds=lat, shard=self._path)
        return data

    @property
    def size(self) -> int:
        return self._length
