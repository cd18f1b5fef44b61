"""Abstract Store backend interface (paper §3.1.1).

A Store backend implements bulk write/read of field data:

- ``archive(data, dataset_key, collocation_key) -> FieldLocation`` — takes
  control of the data (optionally persisting it) and returns a unique
  location descriptor.  Must never overwrite a previously archived field.
- ``archive_batch(items) -> [FieldLocation]`` — archive many fields in one
  backend round; semantically equivalent to sequential ``archive`` calls,
  but backends amortise per-call costs (lock acquisitions, OID allocation,
  event-queue drains) across the batch.
- ``flush()`` — blocks until everything archived by this process is persisted
  and accessible to external readers.
- ``retrieve(location) -> DataHandle`` — backend-agnostic reader.
- ``retrieve_batch(locations) -> [DataHandle | None]`` — vectored reader.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Sequence, Tuple

from .datahandle import DataHandle
from .keys import Key

__all__ = ["FieldLocation", "Store", "ArchiveItem"]


@dataclass(frozen=True)
class FieldLocation:
    """URI-equivalent descriptor of where a field's bytes live.

    ``scheme`` identifies the backend ('daos' | 'posix'); ``uri`` is
    backend-specific (container/OID or file path); offset/length delimit the
    field so reads need no size round-trip (paper §3.1.2: "no call needs to
    be made to DAOS ... to obtain the array size, as that is encoded in the
    field location descriptor").
    """

    scheme: str
    uri: str
    offset: int
    length: int

    def encode(self) -> bytes:
        return f"{self.scheme}|{self.uri}|{self.offset}|{self.length}".encode()

    @classmethod
    def decode(cls, raw: bytes) -> "FieldLocation":
        # The uri is backend-controlled and may itself contain '|' (e.g. a
        # path): scheme is the first field (schemes are identifiers, never
        # contain '|'), offset/length are the last two — everything between
        # is the uri, recovered by splitting from the right.
        scheme, rest = raw.decode().split("|", 1)
        uri, off, ln = rest.rsplit("|", 2)
        return cls(scheme, uri, int(off), int(ln))


#: one element of a Store batch: (data, dataset_key, collocation_key)
ArchiveItem = Tuple[bytes, Key, Key]


class Store(abc.ABC):
    scheme: str

    @abc.abstractmethod
    def archive(self, data: bytes, dataset_key: Key, collocation_key: Key) -> FieldLocation:
        ...

    def archive_batch(self, items: Sequence[tuple[bytes, Key, Key]]) -> list[FieldLocation]:
        """Archive many fields at once.  Sequential default; backends
        override to amortise per-call costs across the batch."""
        return [self.archive(data, ds, co) for data, ds, co in items]

    @abc.abstractmethod
    def flush(self) -> None:
        ...

    @abc.abstractmethod
    def retrieve(self, location: FieldLocation) -> DataHandle:
        ...

    def retrieve_batch(self, locations: Sequence[FieldLocation | None]) -> list[DataHandle | None]:
        """Vectored ``retrieve``; None passes through (absent fields)."""
        return [None if loc is None else self.retrieve(loc) for loc in locations]

    def wipe(self, dataset_key: Key) -> int | None:
        """Remove every store object of one dataset and invalidate any
        cached write state for it (open streams, OID allocators) — without
        this, ``FDB.wipe`` orphans store-side data and a re-archive into the
        wiped dataset hits stale handles.  Returns the number of bytes the
        store physically reclaimed itself, or None when unknown (e.g. the
        catalogue's dataset-directory/container removal already took the
        data).  Called AFTER the catalogue wipe, so the index never points
        at deleted bytes."""
        return None

    def punch(self, location: "FieldLocation") -> int:
        """Reclaim the bytes of ONE field (the lifecycle migrator's wipe
        step).  Returns the bytes physically freed — 0 when this store
        cannot reclaim sub-file/sub-object extents (POSIX packs many fields
        per append-only stream; its space comes back only when the whole
        dataset is wiped).  Called AFTER the catalogue entry is removed, so
        the index never points at punched bytes."""
        del location
        return 0

    def close(self) -> None:  # release cached handles
        pass
