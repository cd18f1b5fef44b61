"""FieldSet — the lazy result of a MARS-style retrieval.

Real FDB's ``retrieve`` hands back one DataHandle over the concatenated GRIB
messages of every matched field.  Our :meth:`FDBClient.retrieve_many` returns
a :class:`FieldSet`: it knows its keys up front (request expansion or
catalogue resolution) but opens the backend handles lazily, in batches, only
as they are consumed — iterating yields ``(Key, DataHandle | None)`` pairs,
and :meth:`FieldSet.handle` exposes the aggregated streaming view
(concatenation of all present fields, byte-addressable across field
boundaries) without materialising any payload.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Iterator, Sequence

from .datahandle import DataHandle
from .keys import Key

__all__ = ["FieldSet", "FieldResolutionError", "ConcatenatedDataHandle"]


class FieldResolutionError(RuntimeError):
    """A FieldSet's fetch returned the wrong number of handles.

    Absent fields are ``None`` entries in a CORRECTLY-sized result; a short
    (or long) result means the fetch itself misbehaved — a torn network
    response, a buggy fan-out — and zipping it would silently leave
    positions stuck at the unresolved sentinel, surfacing much later as a
    bogus handle.  Fail here instead, naming the keys."""

    def __init__(self, expected: int, got: int, keys: Sequence[Key]):
        shown = ", ".join(k.canonical() for k in keys[:5])
        if len(keys) > 5:
            shown += f", ... ({len(keys) - 5} more)"
        super().__init__(
            f"fetch returned {got} handles for {expected} requested keys "
            f"[{shown}] — absent fields must come back as None entries, "
            "never as a short result"
        )
        self.expected = expected
        self.got = got
        self.keys = tuple(keys)


class FieldSet:
    """An ordered set of ``(Key, DataHandle | None)`` pairs, resolved lazily.

    ``fetch`` is the owning client's vectored retrieve: called with a list
    of keys, returns handles in the same order (None for absent fields).
    Resolution happens in chunks of ``batch_size`` on first touch and is
    memoised, so iterating twice costs one backend round per chunk.
    ``batch_size=None`` resolves everything in ONE fetch (used by AsyncFDB,
    whose fetch fans the batch out over its reader pool).
    """

    def __init__(
        self,
        keys: Sequence[Key],
        fetch: Callable[[list[Key]], Sequence[DataHandle | None]],
        *,
        batch_size: int | None = 64,
    ):
        self._keys: tuple[Key, ...] = tuple(keys)
        self._fetch = fetch
        self._batch = len(self._keys) if batch_size is None else max(1, batch_size)
        self._handles: list[DataHandle | None | type(...)] = [...] * len(self._keys)
        self._index: dict[Key, int] = {}
        for i, k in enumerate(self._keys):
            self._index.setdefault(k, i)
        self._mu = threading.Lock()

    # ------------------------------------------------------------- resolution
    def _ensure(self, i: int) -> None:
        """Resolve the chunk containing index *i* (memoised)."""
        with self._mu:
            if self._handles[i] is not ...:
                return
            lo = (i // self._batch) * self._batch
            hi = min(lo + self._batch, len(self._keys))
            idxs = [j for j in range(lo, hi) if self._handles[j] is ...]
            self._resolve(idxs)

    def _resolve(self, idxs: list[int]) -> None:
        """Fetch the given positions and store the handles — after checking
        the fetch honoured its contract (exactly one handle per key)."""
        keys = [self._keys[j] for j in idxs]
        got = list(self._fetch(keys))
        if len(got) != len(idxs):
            raise FieldResolutionError(len(idxs), len(got), keys)
        for j, h in zip(idxs, got):
            self._handles[j] = h

    def _ensure_all(self) -> None:
        """Resolve every unresolved key in ONE fetch — a caller asking for
        the whole set must get the backend's whole-batch amortisation (one
        eq_poll burst on DAOS, one scatter per lane through a router), not
        len/batch_size separate rounds."""
        with self._mu:
            idxs = [j for j, h in enumerate(self._handles) if h is ...]
            if not idxs:
                return
            self._resolve(idxs)

    # -------------------------------------------------------------- container
    @property
    def keys(self) -> tuple[Key, ...]:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self) -> Iterator[tuple[Key, DataHandle | None]]:
        for i, k in enumerate(self._keys):
            self._ensure(i)
            yield k, self._handles[i]

    def items(self) -> Iterator[tuple[Key, DataHandle | None]]:
        return iter(self)

    def __getitem__(self, key: Key) -> DataHandle | None:
        i = self._index.get(key if isinstance(key, Key) else Key(key))
        if i is None:
            raise KeyError(key)
        self._ensure(i)
        return self._handles[i]

    def handle_at(self, i: int) -> DataHandle | None:
        """Handle by POSITION (resolves the containing chunk) — duplicate
        keys in a request map to distinct positions, so positional access is
        what chunked consumers (the codec's :class:`DecodedFieldSet`) use."""
        if not 0 <= i < len(self._keys):
            raise IndexError(i)
        self._ensure(i)
        return self._handles[i]

    def __contains__(self, key: object) -> bool:
        if not isinstance(key, Key):
            try:
                key = Key(key)  # plain mappings accepted, like __getitem__
            except (TypeError, ValueError):
                return False
        return key in self._index

    def __repr__(self) -> str:
        resolved = sum(1 for h in self._handles if h is not ...)
        return f"FieldSet({len(self._keys)} fields, {resolved} resolved)"

    # ------------------------------------------------------------ convenience
    def handles(self) -> list[DataHandle | None]:
        """All handles, in key order (one whole-batch resolve)."""
        self._ensure_all()
        return list(self._handles)

    def to_dict(self) -> dict[Key, DataHandle | None]:
        return dict(zip(self._keys, self.handles()))

    def read_all(self) -> dict[Key, bytes | None]:
        """Materialise every field's payload (closes the handles)."""
        out: dict[Key, bytes | None] = {}
        for k, h in zip(self._keys, self.handles()):
            if h is None:
                out[k] = None
            else:
                try:
                    out[k] = h.read()
                finally:
                    h.close()
        return out

    def missing(self) -> list[Key]:
        """Keys whose field is absent from the FDB (handles resolve)."""
        return [k for k, h in zip(self._keys, self.handles()) if h is None]

    # -------------------------------------------------------------- streaming
    def handle(self) -> "ConcatenatedDataHandle":
        """One streaming DataHandle over the concatenation of every PRESENT
        field, in key order — real FDB's concatenated-GRIB retrieve.  Absent
        fields contribute nothing (check :meth:`missing` when that matters)."""
        return ConcatenatedDataHandle([h for h in self.handles() if h is not None])

    def data(self) -> bytes:
        """The full concatenated payload."""
        h = self.handle()
        try:
            return h.read()
        finally:
            h.close()

    # ------------------------------------------------------------------ codec
    def decode(self, *, chunk: int | None = None, stats=None):
        """View this set through the GRIB codec: a lazy
        :class:`~repro.core.codec.DecodedFieldSet` that unpacks the
        self-describing wire payloads chunk by chunk (one ``grib_unpack``
        launch per chunk) as it is consumed."""
        from .codec import DecodedFieldSet

        return DecodedFieldSet(
            self, chunk=self._batch if chunk is None else chunk, stats=stats
        )


class ConcatenatedDataHandle(DataHandle):
    """A DataHandle over the concatenation of member handles: size is the
    sum, ``read_range`` is byte-addressable across member boundaries and
    only touches the members the range overlaps."""

    def __init__(self, handles: Sequence[DataHandle]):
        self._members = list(handles)
        # prefix offsets: member i spans [starts[i], starts[i+1])
        self._starts = [0]
        for h in self._members:
            self._starts.append(self._starts[-1] + h.size)

    @property
    def size(self) -> int:
        return self._starts[-1]

    def read(self) -> bytes:
        return b"".join(h.read() for h in self._members)

    def read_range(self, offset: int, length: int) -> bytes:
        if offset < 0 or length < 0 or offset + length > self.size:
            raise ValueError("read_range beyond aggregated extent")
        if length == 0:
            return b""
        out: list[bytes] = []
        # first member whose span contains `offset`
        i = bisect.bisect_right(self._starts, offset) - 1
        remaining = length
        pos = offset
        while remaining > 0:
            h = self._members[i]
            local = pos - self._starts[i]
            take = min(remaining, h.size - local)
            out.append(h.read_range(local, take))
            remaining -= take
            pos += take
            i += 1
        return b"".join(out)

    def close(self) -> None:
        for h in self._members:
            h.close()
