"""The sharded in-memory chunk store behind :class:`~repro.cache.CacheFDB`.

Dissemination traffic is massively concurrent, so one big dict under one
big lock would serialise every hit.  The store is split into independent
shards — each with its own lock, LRU order, byte budget and generation
counter — and keys are placed by **consistent hashing** (a crc32 ring with
virtual nodes, the same PYTHONHASHSEED-stable hash the router's writer
lanes use): lookups of distinct keys proceed in parallel, and the ring
keeps placement stable and balanced independent of process hash seeds.

Per shard:

- **LRU by byte budget** — entries are evicted oldest-access-first once the
  shard's share of ``max_bytes`` is exceeded; an entry larger than the whole
  shard budget is refused outright rather than evicting everything for one
  uncacheable giant.
- **TTL expiry** — each entry carries an absolute deadline on the injected
  ``clock`` (monotonic by default; tests inject a fake); expired entries
  read as misses and are dropped on touch.
- **Generation counter** — every invalidation bumps the shard's generation.
  A read-through fill snapshots the generation BEFORE its backend fetch and
  the insert is refused if it moved: a fill racing a concurrent
  archive/wipe can never resurrect stale bytes (the fetched value may
  predate the write that invalidated it).
- **Dataset index** — tokens are indexed by their dataset identifier so
  write-path invalidation (``wipe`` names whole datasets) drops exactly the
  affected entries without scanning the LRU.
"""

from __future__ import annotations

import bisect
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable

__all__ = ["HashRing", "CacheShard", "ShardedCache"]


class HashRing:
    """Consistent-hash ring: crc32 points, ``replicas`` virtual nodes per
    shard.  Deterministic across processes (no PYTHONHASHSEED dependence),
    balanced to a few percent at 32+ vnodes."""

    __slots__ = ("_hashes", "_shards", "n_shards")

    def __init__(self, n_shards: int, replicas: int = 32):
        if n_shards < 1:
            raise ValueError(f"need at least one shard, got {n_shards}")
        points: list[tuple[int, int]] = []
        for s in range(n_shards):
            for v in range(replicas):
                points.append((zlib.crc32(f"shard{s}:vnode{v}".encode()), s))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]
        self.n_shards = n_shards

    def shard_for(self, token: str) -> int:
        """The shard owning *token*: first ring point clockwise of its hash."""
        h = zlib.crc32(token.encode())
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._hashes):
            i = 0
        return self._shards[i]


class _Entry:
    __slots__ = ("data", "expires", "dataset")

    def __init__(self, data: bytes, expires: float | None, dataset: str):
        self.data = data
        self.expires = expires
        self.dataset = dataset


class CacheShard:
    """One independently locked LRU+TTL shard (see module docstring)."""

    def __init__(self, max_bytes: int, clock: Callable[[], float]):
        self._mu = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._by_dataset: dict[str, set[str]] = {}
        self.max_bytes = max_bytes
        self.nbytes = 0
        self.gen = 0
        self._clock = clock

    # ---------------------------------------------------------------- reads
    def get(self, token: str) -> tuple[bytes | None, str]:
        """Look up *token*: ``(data, "hit")``, ``(None, "miss")`` or
        ``(None, "expired")`` (the expired entry is dropped)."""
        with self._mu:
            e = self._entries.get(token)
            if e is None:
                return None, "miss"
            if e.expires is not None and self._clock() >= e.expires:
                self._drop(token, e)
                return None, "expired"
            self._entries.move_to_end(token)
            return e.data, "hit"

    def generation(self) -> int:
        with self._mu:
            return self.gen

    # --------------------------------------------------------------- writes
    def put(
        self,
        token: str,
        data: bytes,
        dataset: str,
        ttl_s: float | None,
        expected_gen: int | None = None,
    ) -> tuple[bool, int, int]:
        """Insert a fill.  Returns ``(inserted, n_evicted, evicted_bytes)``.
        Refused when the shard generation moved past ``expected_gen`` (a
        concurrent invalidation — the fill may be stale) or when the entry
        alone exceeds the shard budget."""
        if len(data) > self.max_bytes:
            return False, 0, 0
        with self._mu:
            if expected_gen is not None and self.gen != expected_gen:
                return False, 0, 0
            old = self._entries.get(token)
            if old is not None:
                self._drop(token, old)
            expires = None if ttl_s is None else self._clock() + ttl_s
            self._entries[token] = _Entry(data, expires, dataset)
            self._by_dataset.setdefault(dataset, set()).add(token)
            self.nbytes += len(data)
            n_ev = ev_bytes = 0
            while self.nbytes > self.max_bytes:
                victim, ve = self._entries.popitem(last=False)
                self.nbytes -= len(ve.data)
                self._unindex(victim, ve)
                n_ev += 1
                ev_bytes += len(ve.data)
            return True, n_ev, ev_bytes

    # --------------------------------------------------------- invalidation
    def invalidate(self, token: str) -> bool:
        """Drop one token; ALWAYS bumps the generation (an in-flight fill of
        any token in this shard must not land over the write that called
        this — the fetched bytes may predate it)."""
        with self._mu:
            self.gen += 1
            e = self._entries.get(token)
            if e is None:
                return False
            self._drop(token, e)
            return True

    def invalidate_dataset(self, dataset: str) -> int:
        with self._mu:
            self.gen += 1
            tokens = self._by_dataset.pop(dataset, None)
            if not tokens:
                return 0
            n = 0
            for token in tokens:
                e = self._entries.pop(token, None)
                if e is not None:
                    self.nbytes -= len(e.data)
                    n += 1
            return n

    def clear(self) -> int:
        with self._mu:
            self.gen += 1
            n = len(self._entries)
            self._entries.clear()
            self._by_dataset.clear()
            self.nbytes = 0
            return n

    # -------------------------------------------------------------- helpers
    def _drop(self, token: str, e: _Entry) -> None:
        del self._entries[token]
        self.nbytes -= len(e.data)
        self._unindex(token, e)

    def _unindex(self, token: str, e: _Entry) -> None:
        ds = self._by_dataset.get(e.dataset)
        if ds is not None:
            ds.discard(token)
            if not ds:
                del self._by_dataset[e.dataset]

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)


class ShardedCache:
    """The consistent-hash composition of :class:`CacheShard` instances.
    ``max_bytes`` is the TOTAL budget, split evenly across shards (the ring
    balances placement, so per-shard budgets approximate a global LRU
    without a global lock)."""

    def __init__(
        self,
        max_bytes: int,
        *,
        n_shards: int = 8,
        replicas: int = 32,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.ring = HashRing(n_shards, replicas)
        self.clock = clock
        per_shard = max(1, max_bytes // n_shards)
        self.shards = [CacheShard(per_shard, clock) for _ in range(n_shards)]

    def _shard(self, token: str) -> CacheShard:
        return self.shards[self.ring.shard_for(token)]

    def get(self, token: str) -> tuple[bytes | None, str]:
        return self._shard(token).get(token)

    def generation(self, token: str) -> int:
        return self._shard(token).generation()

    def put(
        self,
        token: str,
        data: bytes,
        dataset: str,
        ttl_s: float | None,
        expected_gen: int | None = None,
    ) -> tuple[bool, int, int]:
        return self._shard(token).put(token, data, dataset, ttl_s, expected_gen)

    def invalidate(self, token: str) -> bool:
        return self._shard(token).invalidate(token)

    def invalidate_dataset(self, dataset: str) -> int:
        return sum(s.invalidate_dataset(dataset) for s in self.shards)

    def clear(self) -> int:
        return sum(s.clear() for s in self.shards)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)
