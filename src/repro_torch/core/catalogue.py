"""Abstract Catalogue backend interface (paper §3.2.1).

The Catalogue maintains the index: element key -> field location, organised
under dataset and collocation keys.  The index must *always* be consistent
from the perspective of an external reader, even under read/write
contention; replacement (re-archive of the same identifier) must be
transactional.  ``retrieve`` of an absent field is NOT an error (the FDB may
be used as a cache) — it returns None.
"""

from __future__ import annotations

import abc
from typing import Iterable, Iterator, Mapping, Sequence, Tuple

from .keys import Key
from .schema import Schema
from .store import FieldLocation

__all__ = ["Catalogue", "ListEntry", "IndexEntry", "IndexTriple"]

#: one element of a Catalogue archive batch
IndexEntry = Tuple[Key, Key, Key, FieldLocation]  # (dataset, collocation, element, location)
#: one element of a Catalogue retrieve batch
IndexTriple = Tuple[Key, Key, Key]  # (dataset, collocation, element)


class ListEntry:
    __slots__ = ("key", "location")

    def __init__(self, key: Key, location: FieldLocation):
        self.key = key
        self.location = location

    def __repr__(self) -> str:
        return f"ListEntry({self.key!r} -> {self.location})"


class Catalogue(abc.ABC):
    def __init__(self, schema: Schema):
        self.schema = schema

    @abc.abstractmethod
    def archive(self, dataset_key: Key, collocation_key: Key, element_key: Key, location: FieldLocation) -> None:
        """Insert element->location into the index (maybe only in memory)."""

    def archive_batch(self, entries: Sequence[IndexEntry]) -> None:
        """Insert many element->location mappings in one round.  Sequential
        default; backends override to amortise index-object resolution and
        lock/round-trip costs across the batch."""
        for ds, co, el, loc in entries:
            self.archive(ds, co, el, loc)

    @abc.abstractmethod
    def flush(self) -> None:
        """Persist + publish all indexed info to external readers/listers."""

    @abc.abstractmethod
    def retrieve(self, dataset_key: Key, collocation_key: Key, element_key: Key) -> FieldLocation | None:
        ...

    def retrieve_batch(self, triples: Sequence[IndexTriple]) -> list[FieldLocation | None]:
        """Vectored ``retrieve``; absent fields come back as None."""
        return [self.retrieve(ds, co, el) for ds, co, el in triples]

    @abc.abstractmethod
    def list(self, request: Mapping[str, Iterable[str] | str]) -> Iterator[ListEntry]:
        """All (identifier, location) pairs matching a partial request."""

    def remove_batch(self, triples: Sequence[IndexTriple]) -> list["FieldLocation | None"]:
        """Remove individual index entries (the lifecycle migrator's wipe
        step — field-granular, unlike dataset-granular :meth:`wipe`).
        Returns each entry's prior location (None if it was absent) so the
        Store can reclaim the bytes.  Optional: backends without per-field
        removal raise."""
        raise NotImplementedError(f"{type(self).__name__} has no per-field removal")

    @abc.abstractmethod
    def wipe(self, dataset_key: Key) -> None:
        """Efficiently remove an entire dataset (rolling-archive use)."""

    def close(self) -> None:
        pass
