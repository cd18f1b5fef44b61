"""DAOS object emulation: OIDs, MVCC Key-Value and Array objects.

MVCC model (paper §2): a write is persisted into a *new* region/version and
then atomically published in a persistent index; a read visits the index and
returns the latest fully-written version.  No locks; readers never block
writers.  We emulate with per-object version chains guarded by a mutation
lock (the "atomic index insert" — cheap and server-local, unlike Lustre's
client-visible distributed locks) while reads are lock-free snapshots.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Iterable

__all__ = ["ObjectId", "KVObject", "ArrayObject", "OC_S1", "OC_SX"]

# Object classes (paper §2/§5.1: OC_S1 — single stripe — was optimal for the
# relatively small fields; OC_SX stripes over all targets).
OC_S1 = "OC_S1"
OC_SX = "OC_SX"


@dataclass(frozen=True, order=True)
class ObjectId:
    """128-bit DAOS object id: 96 user-managed bits + 32 reserved (class...)."""

    hi: int
    lo: int

    def __str__(self) -> str:  # canonical 'hi.lo' form, e.g. '0.0' for root KVs
        return f"{self.hi}.{self.lo}"

    @classmethod
    def parse(cls, s: str) -> "ObjectId":
        hi, lo = s.split(".")
        return cls(int(hi), int(lo))


#: the well-known root object id used by the Catalogue backend (paper §3.2.2)
ROOT_OID = ObjectId(0, 0)

_epoch_counter = itertools.count(1)
_epoch_lock = threading.Lock()


def _next_epoch() -> int:
    with _epoch_lock:
        return next(_epoch_counter)


class _Tombstone:
    __slots__ = ()

    def __repr__(self) -> str:
        return "<tombstone>"


TOMBSTONE = _Tombstone()


class KVObject:
    """High-level Key-Value object: string keys -> byte values, MVCC.

    ``put`` appends an immutable version and atomically publishes it;
    ``get`` reads the latest published version without locking.
    """

    def __init__(self, oid: ObjectId, oclass: str = OC_S1):
        self.oid = oid
        self.oclass = oclass
        # key -> list of (epoch, value-bytes | TOMBSTONE); append-only
        self._chains: dict[str, list[tuple[int, bytes | _Tombstone]]] = {}
        self._mu = threading.Lock()  # the atomic index-insert step only

    def put(self, key: str, value: bytes) -> int:
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError("KV values are byte strings")
        value = bytes(value)
        epoch = _next_epoch()
        with self._mu:
            self._chains.setdefault(key, []).append((epoch, value))
        return epoch

    def get(self, key: str) -> bytes | None:
        chain = self._chains.get(key)
        if not chain:
            return None
        # lock-free read of the latest published version: list.append is
        # atomic under the GIL and versions are immutable once linked.
        epoch, value = chain[-1]
        if value is TOMBSTONE:
            return None
        return value  # type: ignore[return-value]

    def get_size(self, key: str) -> int | None:
        v = self.get(key)
        return None if v is None else len(v)

    def remove(self, key: str) -> None:
        epoch = _next_epoch()
        with self._mu:
            self._chains.setdefault(key, []).append((epoch, TOMBSTONE))

    def list_keys(self) -> list[str]:
        # snapshot; a key is listed iff its latest version is not a tombstone
        out = []
        for k, chain in list(self._chains.items()):
            if chain and chain[-1][1] is not TOMBSTONE:
                out.append(k)
        return sorted(out)

    def version_count(self, key: str) -> int:
        return len(self._chains.get(key, ()))


@dataclass
class _Extent:
    offset: int
    data: bytes
    epoch: int

    @property
    def end(self) -> int:
        return self.offset + len(self.data)


class ArrayObject:
    """Array object: byte-granular ranged write/read with MVCC extents.

    Writes never modify prior regions — each lands as a new extent tagged
    with a fresh epoch; reads resolve overlaps by "latest epoch wins".
    This is the paper's "writes always occur in new regions without
    modifying data potentially being read".
    """

    def __init__(self, oid: ObjectId, oclass: str = OC_S1, cell_size: int = 1, chunk_size: int = 1 << 20):
        self.oid = oid
        self.oclass = oclass
        self.cell_size = cell_size
        self.chunk_size = chunk_size
        self._extents: list[_Extent] = []
        self._mu = threading.Lock()
        self._size = 0

    def write(self, offset: int, data: bytes) -> None:
        if offset < 0:
            raise ValueError("negative offset")
        ext = _Extent(offset=offset, data=bytes(data), epoch=_next_epoch())
        with self._mu:
            self._extents.append(ext)
            self._size = max(self._size, ext.end)

    def read(self, offset: int = 0, length: int | None = None) -> bytes:
        # snapshot of published extents (append-only ⇒ consistent prefix)
        extents = self._extents[:]
        size = self._size
        if length is None:
            length = max(0, size - offset)
        buf = bytearray(length)
        filled = bytearray(length)  # visibility mask
        # later epochs win: extents list is in epoch order already
        for ext in extents:
            lo = max(offset, ext.offset)
            hi = min(offset + length, ext.end)
            if lo >= hi:
                continue
            buf[lo - offset : hi - offset] = ext.data[lo - ext.offset : hi - ext.offset]
            filled[lo - offset : hi - offset] = b"\x01" * (hi - lo)
        return bytes(buf)

    def get_size(self) -> int:
        return self._size

    def punch(self) -> None:
        with self._mu:
            self._extents.clear()
            self._size = 0


def hash_dkey_to_target(dkey: str, n_targets: int) -> int:
    """Deterministic dkey -> target placement (paper §2: 'All entries indexed
    under the same dkey are collocated in the same target')."""
    import zlib

    return zlib.crc32(dkey.encode()) % max(1, n_targets)


def iter_chunks(data: bytes, chunk: int) -> Iterable[bytes]:
    for i in range(0, len(data), chunk):
        yield data[i : i + chunk]
