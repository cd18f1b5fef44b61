"""Abstract reader handles returned by Store.retrieve (paper §3.1.1)."""

from __future__ import annotations

import abc

__all__ = ["DataHandle", "FieldGoneError", "MemoryDataHandle"]


class FieldGoneError(LookupError):
    """The field vanished between catalogue resolution and the byte read.

    Store handles are lazy: ``retrieve`` resolves a location, the bytes are
    only touched on ``read``.  A concurrent ``wipe`` (or a lifecycle
    migration removing the source copy after its flip) can land in that
    window, on either backend — the POSIX handle would hit a deleted data
    file, the DAOS handle a destroyed container.  Handles raise THIS error
    instead of leaking the backend exception, so ``FDBClient.read`` can
    re-resolve once and then answer ``None`` — a torn handle never escapes
    to the caller."""


class DataHandle(abc.ABC):
    @abc.abstractmethod
    def read(self) -> bytes:
        """Read the full field."""

    @abc.abstractmethod
    def read_range(self, offset: int, length: int) -> bytes:
        """Byte-granular partial read within the field."""

    @property
    @abc.abstractmethod
    def size(self) -> int:
        ...

    def close(self) -> None:
        pass


class MemoryDataHandle(DataHandle):
    def __init__(self, data: bytes):
        self._data = data

    def read(self) -> bytes:
        return self._data

    def read_range(self, offset: int, length: int) -> bytes:
        return self._data[offset : offset + length]

    @property
    def size(self) -> int:
        return len(self._data)
