"""CacheFDB — the read-through dissemination cache facade.

The paper's workflow is write-once read-many-millions (§1): the archive
side is one I/O-server burst, the read side is every downstream consumer
asking for the same freshly produced fields at once.  This facade makes
that fan-out cheap while staying a drop-in :class:`~repro.core.FDBClient`
tier (``{"type": "cache", "inner": {...}}`` in
:func:`~repro.core.config.build_fdb` — it composes above SelectFDB,
CodecFDB, AsyncFDB or RemoteFDB unchanged):

- **read-through**: ``retrieve``/``retrieve_batch`` serve payload bytes
  from the consistent-hash sharded store (:mod:`repro.cache.shard`) and
  fall through to the inner client on a miss, filling on the way back;
- **single-flight**: concurrent misses of one key elect a leader that pays
  ONE inner round; followers block on its flight
  (:mod:`repro.cache.singleflight`).  Partial ``retrieve_many`` requests
  coalesce the same way at the request-resolution level, so N identical
  MARS requests cost one catalogue listing;
- **write-path invalidation**: ``archive``/``archive_batch``/
  ``archive_fields`` invalidate exactly the touched keys, ``wipe`` drops
  the touched datasets (the granularity :class:`~repro.core.WipeReport`
  names); generation counters refuse fills that raced a write, so stale
  bytes are never resurrected;
- **async write ordering**: over a deferred-visibility inner (AsyncFDB, a
  remote server still coalescing), a read of a key this client archived
  but has not flushed would race the background writer.  The facade keeps
  a *dirty set* and :meth:`read_barrier` — the explicit ordering hook —
  flushes the inner tree before serving any read that touches a dirty key,
  so read-your-writes holds without callers sprinkling ``flush()``.

Correctness bar: a cached retrieve is byte-for-byte the backend retrieve —
the cache stores wire payloads, so lazy codec'd
:class:`~repro.core.codec.DecodedFieldSet` reads decode identically from a
hit — and reads after ``wipe``/re-archive never serve stale chunks.

Telemetry: hits/misses/coalesced waits/evictions are spans
(``cache.hit``/``cache.miss``/``cache.coalesced_wait``/``cache.evict``)
and IOStats ops on a dedicated ``"cache"`` sink.  Bytes served from the
cache live in ``counters["cache_bytes_served"]`` — never in
``bytes_read`` — so merged snapshots never double-count backend bytes.
An optional contention model charges hits at client-memory speed
(:meth:`~repro.metrics.contention.ContentionModel.cache_hit`), which is
what moves the read-side knee right in ``fdb_hammer --scaling``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, Mapping, Sequence

from ..core.client import FDBClient, WipeReport
from ..core.datahandle import DataHandle, MemoryDataHandle
from ..core.fieldset import FieldResolutionError, FieldSet
from ..core.keys import Key
from ..core.request import Request, as_request
from ..core.schema import Schema
from ..metrics.iostats import IOStats
from .shard import ShardedCache
from .singleflight import SingleFlight

__all__ = ["CacheFDB"]

#: default total byte budget (a dissemination node's RAM slice)
DEFAULT_MAX_BYTES = 256 << 20


class CacheFDB(FDBClient):
    """Read-through sharded field cache with single-flight coalescing
    (see module docstring).

    Parameters: ``max_bytes`` total budget, ``ttl_s`` default entry TTL
    (None = no expiry), ``dataset_ttl`` per-dataset overrides as
    ``[{"match": <MARS request>, "ttl_s": <s>}, ...]`` (first match wins),
    ``shards``/``replicas`` the consistent-hash layout, ``negative_ttl``
    the absence-memo TTL (None = absent fields are never cached — every
    miss for a not-yet-archived field pays a full backend round; set it
    short, e.g. the dissemination poll interval, for workloads that probe
    ahead of the forecast), ``clock`` the TTL clock (injectable for
    tests), ``contention`` an optional
    :class:`~repro.metrics.contention.ContentionModel` charged at memory
    speed per cache-served byte."""

    def __init__(
        self,
        inner: FDBClient,
        *,
        max_bytes: int = DEFAULT_MAX_BYTES,
        ttl_s: float | None = None,
        dataset_ttl: Sequence[Mapping] = (),
        shards: int = 8,
        replicas: int = 32,
        negative_ttl: float | None = None,
        owns_inner: bool = True,
        clock: Callable[[], float] = time.monotonic,
        contention=None,
    ):
        self.inner = inner
        self.schema: Schema = inner.schema
        self._codec_nbits = getattr(inner, "_codec_nbits", type(self)._codec_nbits)
        self._fieldset_batch = inner._fieldset_batch
        self._owns_inner = owns_inner
        self._cache = ShardedCache(
            max_bytes, n_shards=shards, replicas=replicas, clock=clock
        )
        self._ttl_s = None if ttl_s is None else float(ttl_s)
        self._ttl_rules: list[tuple[Request, float | None]] = [
            (as_request(rule["match"]),
             None if rule["ttl_s"] is None else float(rule["ttl_s"]))
            for rule in dataset_ttl
        ]
        self._flight = SingleFlight()
        # request-resolution coalescing + memoisation for partial requests
        self._req_flight = SingleFlight()
        self._req_cache: dict[str, tuple[tuple[Key, ...], float | None]] = {}
        self._req_gen = 0
        # keys archived through this facade but possibly not yet published
        # by the inner tree (AsyncFDB queue, remote coalescing window)
        self._dirty: set[Key] = set()
        self._mu = threading.Lock()  # guards _dirty, _req_cache, _req_gen, _neg
        # negative cache: token -> expiry on the cache clock.  Entries are
        # generation-guarded on store and dropped by every write/move/wipe
        # of the key, so "absent" is never served past the publication that
        # made it wrong (within one process; cross-process it is a TTL).
        self._neg_ttl = None if negative_ttl is None else float(negative_ttl)
        self._neg: dict[str, float] = {}
        self.cache_stats = IOStats("cache")
        self._contention = contention
        # a lifecycle engine below migrates fields between tiers without an
        # archive flowing through this facade: hook its flip so moved keys
        # are invalidated (the bytes are identical, but codec'd tiers may
        # differ, and the negative cache must forget promoted keys)
        from ..lifecycle.engine import LifecycleFDB

        stack, seen = [inner], set()
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, LifecycleFDB):
                node.add_move_listener(self._note_moved)
            for attr in ("inner", "fdb"):
                sub = getattr(node, attr, None)
                if isinstance(sub, FDBClient):
                    stack.append(sub)
            for attr in ("tiers", "lanes"):
                subs = getattr(node, attr, None)
                if subs:
                    stack.extend(s for s in subs if isinstance(s, FDBClient))

    # ----------------------------------------------------------- key tokens
    @staticmethod
    def _token(key: Key) -> str:
        # sorted, self-describing: Key equality is order-insensitive, so the
        # cache identity must be too (canonical() preserves insertion order)
        return ";".join(f"{k}={v}" for k, v in sorted(key.items()))

    def _ds_token(self, key: Key) -> str:
        return self._token(key.subset(self.schema.dataset_keys))

    def _ttl_for(self, key: Key) -> float | None:
        for match, ttl in self._ttl_rules:
            if key.matches(match):
                return ttl
        return self._ttl_s

    # ------------------------------------------------------- write ordering
    def read_barrier(self, keys: Sequence[Key] | None = None) -> None:
        """The explicit ordering hook between this client's writes and its
        reads: if any of *keys* (all dirty keys when None) was archived
        through this facade but possibly not yet published by the inner
        tree, flush the inner tree first.  Every invalidation-sensitive
        read path calls this, so ``archive -> retrieve`` through a
        ``cache``-over-``async`` composition is read-your-writes without a
        caller ``flush()``.  Reads of clean keys never pay the barrier."""
        with self._mu:
            if not self._dirty:
                return
            if keys is not None and not any(k in self._dirty for k in keys):
                return
        self.flush()

    def _note_write(self, keys: Sequence[Key]) -> None:
        """Write-path invalidation: drop the touched entries (bumping shard
        generations, so racing fills are refused), clear the memoised
        request resolutions, and mark the keys dirty for the barrier."""
        with self._mu:
            self._dirty.update(keys)
            self._req_gen += 1
            self._req_cache.clear()
            for k in keys:
                self._neg.pop(self._token(k), None)
        for k in keys:
            self._cache.invalidate(self._token(k))

    def _note_moved(self, keys: Sequence[Key]) -> None:
        """Migration-path invalidation (lifecycle flip listener): drop the
        moved keys' cached entries, memos and negative entries.  Unlike
        :meth:`_note_write` this does NOT mark keys dirty — the destination
        copy is already flushed and published when the flip happens."""
        with self._mu:
            self._req_gen += 1
            self._req_cache.clear()
            for k in keys:
                self._neg.pop(self._token(k), None)
        for k in keys:
            self._cache.invalidate(self._token(k))

    # ----------------------------------------------------------- write path
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        key = self._as_key(key)
        self._note_write([key])
        self.inner.archive(key, data)

    def archive_batch(self, items) -> None:
        items = [(self._as_key(k), d) for k, d in items]
        self._note_write([k for k, _ in items])
        self.inner.archive_batch(items)

    def archive_fields(self, keys, fields, *, nbits: int | None = None) -> None:
        # delegate WITHOUT packing here: routing facades below (SelectFDB)
        # must split the batch so each codec tier packs at its own width
        keys = [self._as_key(k) for k in keys]
        self._note_write(keys)
        self.inner.archive_fields(keys, fields, nbits=nbits)

    def flush(self) -> None:
        self.inner.flush()
        with self._mu:
            self._dirty.clear()

    def drain(self) -> None:
        # bytes reached the backend, but deferred-visibility backends may
        # not have published them: keys stay dirty until flush()
        self.inner.drain()

    # ------------------------------------------------------------ read path
    def retrieve_batch(self, keys) -> list[DataHandle | None]:
        keys = [self._as_key(k) for k in keys]
        tr = self._trace
        with tr.span("cache.retrieve_batch") as sp:
            self.read_barrier(keys)
            # dedupe within the batch: one lookup/flight per distinct key
            order: list[tuple[str, Key]] = []
            positions: dict[str, list[int]] = {}
            for i, k in enumerate(keys):
                t = self._token(k)
                if t not in positions:
                    positions[t] = []
                    order.append((t, k))
                positions[t].append(i)

            resolved: dict[str, bytes | None] = {}
            leaders: list[tuple[str, Key, object, int]] = []
            waits: list[tuple[str, object]] = []
            hits = served_b = neg_hits = 0
            for tok, k in order:
                data, status = self._cache.get(tok)
                if status == "hit":
                    hits += 1
                    served_b += len(data)
                    resolved[tok] = data
                    if tr.enabled:
                        with tr.span("cache.hit") as hsp:
                            hsp.set("nbytes", len(data))
                    if self._contention is not None:
                        self._contention.cache_hit(len(data))
                    continue
                if self._neg_ttl is not None:
                    with self._mu:
                        exp = self._neg.get(tok)
                        if exp is not None and self._cache.clock() >= exp:
                            del self._neg[tok]
                            exp = None
                    if exp is not None:
                        # memoised absence: no backend round, no flight
                        neg_hits += 1
                        resolved[tok] = None
                        if tr.enabled:
                            with tr.span("cache.neg_hit"):
                                pass
                        if self._contention is not None:
                            self._contention.cache_hit(0)
                        continue
                flight, is_leader = self._flight.join(tok)
                if is_leader:
                    # snapshot the shard generation BEFORE the fetch: a
                    # write racing this fill bumps it and the insert is
                    # refused (the fetched bytes may predate the write)
                    leaders.append((tok, k, flight, self._cache.generation(tok)))
                else:
                    waits.append((tok, flight))

            backend_b = evicts = evict_b = 0
            if leaders:
                backend_b, evicts, evict_b = self._lead_fetch(leaders, resolved, tr)
            for tok, flight in waits:
                with tr.span("cache.coalesced_wait") as wsp:
                    data = self._flight.wait(flight)
                    if tr.enabled:
                        wsp.set("nbytes", 0 if data is None else len(data))
                resolved[tok] = data
                if data is not None:
                    served_b += len(data)
                    if self._contention is not None:
                        self._contention.cache_hit(len(data))

            self._account(
                hits=hits, misses=len(leaders), coalesced=len(waits),
                served_b=served_b, backend_b=backend_b,
                evicts=evicts, evict_b=evict_b, neg_hits=neg_hits,
            )
            if tr.enabled:
                sp.set("n_keys", len(keys))
                sp.set("hits", hits)
                sp.set("misses", len(leaders))
                sp.set("coalesced", len(waits))

            out: list[DataHandle | None] = [None] * len(keys)
            for tok, _ in order:
                data = resolved[tok]
                if data is None:
                    continue
                for i in positions[tok]:
                    out[i] = MemoryDataHandle(data)
            return out

    def _lead_fetch(self, leaders, resolved, tr) -> tuple[int, int, int]:
        """Pay ONE inner round for all leader keys; publish each flight's
        outcome (errors included — they propagate to followers and are
        never cached) and fill the cache, generation-guarded."""
        fetch_keys = [k for _, k, _, _ in leaders]
        try:
            with tr.span("cache.miss") as msp:
                handles = self.inner.retrieve_batch(fetch_keys)
                if tr.enabled:
                    msp.set("n_keys", len(fetch_keys))
            if len(handles) != len(leaders):
                raise FieldResolutionError(
                    f"inner retrieve_batch returned {len(handles)} handles "
                    f"for {len(leaders)} keys"
                )
        except BaseException as e:
            for tok, _, flight, _ in leaders:
                self._flight.complete(tok, flight, error=e)
            raise
        backend_b = evicts = evict_b = 0
        done = 0
        try:
            for (tok, k, flight, gen), h in zip(leaders, handles):
                if h is None:
                    data = None
                    if self._neg_ttl is not None:
                        # memoise the absence, generation-guarded like a
                        # fill: an archive that raced this fetch bumped the
                        # generation (and purged the token from _neg), so a
                        # stale "absent" is never stored over fresh bytes
                        if self._cache.generation(tok) == gen:
                            with self._mu:
                                self._neg[tok] = self._cache.clock() + self._neg_ttl
                            self.cache_stats.record("cache_neg_store")
                else:
                    try:
                        data = h.read()
                    finally:
                        h.close()
                if data is not None:
                    backend_b += len(data)
                    _, n_ev, ev_b = self._cache.put(
                        tok, data, self._ds_token(k), self._ttl_for(k),
                        expected_gen=gen,
                    )
                    evicts += n_ev
                    evict_b += ev_b
                self._flight.complete(tok, flight, value=data)
                done += 1
                resolved[tok] = data
        except BaseException as e:
            # a failed handle read must not strand the LATER leaders'
            # followers: every still-open flight observes the error
            for tok, _, flight, _ in leaders[done:]:
                self._flight.complete(tok, flight, error=e)
            raise
        if evicts and tr.enabled:
            with tr.span("cache.evict") as esp:
                esp.set("n_entries", evicts)
                esp.set("nbytes", evict_b)
        return backend_b, evicts, evict_b

    # ------------------------------------------------- request-level reads
    def retrieve_many(self, request) -> FieldSet:
        tr = self._trace
        with tr.span("cache.retrieve_many") as sp:
            req = self._validated_request(request)
            if req.is_exact(self.schema):
                keys = req.expand(self.schema)
            else:
                keys = self._resolve_keys(req)
            if tr.enabled:
                sp.set("n_keys", len(keys))
            return FieldSet(keys, self._many_fetch, batch_size=self._fieldset_batch)

    def _resolve_keys(self, req: Request) -> list[Key]:
        """Partial-request resolution with memoisation + single-flight: N
        concurrent identical MARS requests cost one catalogue listing, and
        the resolved key list is cached (default TTL) until any write
        invalidates it."""
        text = req.format()
        with self._mu:
            dirty = bool(self._dirty)
        if dirty:
            # an unpublished archive may extend this listing: publish first
            self.flush()
        with self._mu:
            hit = self._req_cache.get(text)
            if hit is not None:
                cached, expires = hit
                if expires is None or self._cache.clock() < expires:
                    self.cache_stats.record("cache_list_hit")
                    return list(cached)
                del self._req_cache[text]
        flight, is_leader = self._req_flight.join(text)
        if not is_leader:
            self.cache_stats.record("cache_list_coalesced")
            return list(self._req_flight.wait(flight))
        try:
            with self._mu:
                gen = self._req_gen
            keys = tuple(e.key for e in self._inner_list(req))
        except BaseException as e:
            self._req_flight.complete(text, flight, error=e)
            raise
        with self._mu:
            if self._req_gen == gen:  # no write raced the listing
                expires = (
                    None if self._ttl_s is None
                    else self._cache.clock() + self._ttl_s
                )
                self._req_cache[text] = (keys, expires)
        self.cache_stats.record("cache_list_fill")
        self._req_flight.complete(text, flight, value=keys)
        return list(keys)

    def _inner_list(self, request: Request):
        return getattr(self.inner, "_list", self.inner.list)(request)

    def _list(self, request: Request) -> Iterator:
        return self._inner_list(request)

    # ------------------------------------------------------------ wipe path
    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        report = self.inner._wipe_dataset(dataset_key, entries)
        # invalidate at the granularity the report names: whole datasets
        # (base wipe() calls this once per matched dataset key)
        self._cache.invalidate_dataset(self._ds_token(dataset_key))
        with self._mu:
            self._req_gen += 1
            self._req_cache.clear()
            # negative entries are keyed by full token (cheap to clear,
            # expensive to filter by dataset): drop them all — re-probing an
            # absent field once per wipe is the conservative trade
            self._neg.clear()
        return report

    # ------------------------------------------------------------ telemetry
    def _account(self, *, hits, misses, coalesced, served_b, backend_b,
                 evicts, evict_b, neg_hits=0) -> None:
        st = self.cache_stats
        with st.lock:
            if hits:
                st.ops["cache_hit"] += hits
            if neg_hits:
                st.ops["cache_neg_hit"] += neg_hits
            if misses:
                st.ops["cache_miss"] += misses
            if coalesced:
                st.ops["cache_coalesced_wait"] += coalesced
            if evicts:
                st.ops["cache_evict"] += evicts
            # bytes served without a backend round vs bytes the backend
            # actually moved for fills — deliberately NOT bytes_read, which
            # the inner sinks already account (no double-counting on merge)
            if served_b:
                st.counters["cache_bytes_served"] += served_b
            if backend_b:
                st.counters["cache_bytes_backend"] += backend_b
            if evict_b:
                st.counters["cache_bytes_evicted"] += evict_b

    def io_stats(self) -> list:
        return list(self.inner.io_stats()) + [self.cache_stats] + self._codec_sinks()

    def cache_snapshot(self) -> dict:
        """The cache-tier scorecard: hit/miss/coalesced counts, hit rate
        (cache-served lookups over all lookups) and the dissemination win —
        bytes served per backend byte."""
        with self.cache_stats.lock:
            ops = dict(self.cache_stats.ops)
            counters = dict(self.cache_stats.counters)
        hits = ops.get("cache_hit", 0)
        misses = ops.get("cache_miss", 0)
        coalesced = ops.get("cache_coalesced_wait", 0)
        served = counters.get("cache_bytes_served", 0)
        backend = counters.get("cache_bytes_backend", 0)
        lookups = hits + misses + coalesced
        with self._mu:
            neg_entries = len(self._neg)
        return {
            "hits": hits,
            "misses": misses,
            "coalesced": coalesced,
            "evictions": ops.get("cache_evict", 0),
            "hit_rate": (hits + coalesced) / lookups if lookups else 0.0,
            "neg_hits": ops.get("cache_neg_hit", 0),
            "neg_stores": ops.get("cache_neg_store", 0),
            "neg_entries": neg_entries,
            "bytes_served": served,
            "bytes_backend": backend,
            "bytes_served_per_backend_byte": (
                (served + backend) / backend if backend else 0.0
            ),
            "entries": len(self._cache),
            "bytes_cached": self._cache.nbytes,
        }

    # ------------------------------------------------------------ lifecycle
    def invalidate_all(self) -> int:
        """Drop every cached entry and memoised resolution (e.g. when an
        EXTERNAL writer shares the inner tree); returns entries dropped."""
        with self._mu:
            self._req_gen += 1
            self._req_cache.clear()
            self._neg.clear()
        return self._cache.clear()

    def close(self) -> None:
        if self._owns_inner:
            self.inner.close()
        else:
            self.inner.flush()
        with self._mu:
            self._dirty.clear()
            self._req_cache.clear()
            self._neg.clear()
        self._cache.clear()

    def __repr__(self) -> str:
        return (
            f"CacheFDB(max_bytes={sum(s.max_bytes for s in self._cache.shards)}, "
            f"shards={len(self._cache.shards)}, inner={self.inner!r})"
        )
