"""LifecycleFDB — the online tier-migration engine.

A pass-through :class:`~repro.core.client.FDBClient` facade that (a)
observes every archive and access flowing to the tree below it, and (b)
runs policy-driven migrations between the tiers of the
:class:`~repro.core.SelectFDB` it finds underneath.

The migration protocol for one batch of fields moving ``src -> dst``
(pin / copy / flip / remove) keeps the §1.3 store-before-catalogue
invariant true *across tiers*, so a concurrent reader always resolves
exactly one authoritative copy:

1. **pin** — the SelectFDB placement overlay pins every key to ``src``.
   From here on the routing answer is frozen regardless of what the
   static rules would say, so the copy we are about to make on ``dst``
   stays invisible even once it is catalogued there.
2. **copy** — ``read_batch`` from ``src``, ``archive_batch`` + ``flush``
   on ``dst``.  Within ``dst`` the ordinary store-before-catalogue flush
   discipline applies; at the select layer the overlay hides it.
3. **flip** — the overlay entry swings to ``dst`` (one dict write under
   the overlay lock, per key).  This is the linearisation point: before
   it readers got the ``src`` copy, after it the ``dst`` copy; there is
   no instant with zero or two visible copies.  Move listeners (cache
   invalidation) fire here.
4. **remove** — the ``src`` copy is removed field-granularly,
   catalogue-entry first (tombstone segment on POSIX, MVCC ``kv_remove``
   on DAOS) then store bytes (``obj_punch`` on DAOS).  A reader that
   resolved a ``src`` handle *before* the flip and reads *after* the
   punch hits :class:`~repro.core.datahandle.FieldGoneError`, and
   ``FDBClient.read`` re-resolves through the flipped overlay to ``dst``
   — a full field or None, never a torn read.

Every batch emits ``lifecycle.scan/copy/flip/wipe`` spans through
:mod:`repro.obs`, and all migration I/O flows through the tiers' normal
stores/engines, so the contention models charge it against the same
modelled hardware the foreground traffic uses — which is exactly what
``fdb_hammer --churn`` measures.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Mapping, Sequence

from ..core.catalogue import ListEntry
from ..core.client import FDBClient, WipeReport
from ..core.datahandle import DataHandle
from ..core.keys import Key
from ..core.request import Request
from ..core.select import SelectFDB
from .policy import LifecyclePolicy

__all__ = ["LifecycleFDB", "MigrationReport"]


@dataclass
class MigrationReport:
    """What one engine cycle did."""

    scanned: int = 0  #: tracked fields considered
    demoted: int = 0
    promoted: int = 0
    batches: int = 0
    bytes_moved: int = 0
    #: fields that disappeared (wipe race) between scan and copy — skipped
    vanished: int = 0

    @property
    def migrated(self) -> int:
        return self.demoted + self.promoted


class _Meta:
    """Per-field lifecycle record (mutated under the engine lock)."""

    __slots__ = ("archived_at", "accesses")

    def __init__(self, archived_at: float):
        self.archived_at = archived_at
        self.accesses = 0


def _find_select(client: FDBClient) -> SelectFDB:
    c = client
    seen: set[int] = set()
    while c is not None and id(c) not in seen:
        if isinstance(c, SelectFDB):
            return c
        seen.add(id(c))
        c = getattr(c, "inner", None) or getattr(c, "fdb", None)
    raise ValueError(
        "lifecycle needs a SelectFDB somewhere below it (tiers to migrate between)"
    )


class LifecycleFDB(FDBClient):
    def __init__(
        self,
        inner: FDBClient,
        policies: Sequence[LifecyclePolicy | Mapping],
        *,
        clock: Callable[[], float] | None = None,
        batch_size: int = 64,
        owns_inner: bool = True,
    ):
        """``inner``: the tree to decorate — must contain a SelectFDB.
        ``policies``: :class:`LifecyclePolicy` objects or their dict form.
        ``clock``: seconds-valued callable ages are measured on (pass the
        contention model's virtual clock in discrete-event sweeps; defaults
        to ``time.monotonic``).  ``batch_size``: fields per copy/flip/remove
        batch."""
        self.inner = inner
        self.schema = inner.schema
        self._owns_inner = owns_inner
        self._clock = clock if clock is not None else time.monotonic
        if batch_size < 1:
            raise ValueError("lifecycle batch_size must be >= 1")
        self._batch = batch_size
        self.select = _find_select(inner)
        self.policies: tuple[LifecyclePolicy, ...] = tuple(
            p if isinstance(p, LifecyclePolicy) else LifecyclePolicy.from_dict(p)
            for p in policies
        )
        if not self.policies:
            raise ValueError("lifecycle needs at least one policy")
        for p in self.policies:
            # unknown tier names are config typos — fail at build, not mid-run
            self.select.resolve_tier(p.from_tier)
            self.select.resolve_tier(p.to_tier)
        self._mu = threading.Lock()
        self._meta: dict[Key, _Meta] = {}
        self._promote: dict[Key, str] = {}  # key -> destination tier name
        self._listeners: list[Callable[[list[Key]], None]] = []
        self._migrated_total = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ observation
    def _note_archived(self, keys: Sequence[Key]) -> None:
        now = self._clock()
        with self._mu:
            for k in keys:
                self._meta[k] = _Meta(now)
                # a re-archive resets the lifecycle; a queued promotion for
                # the old bytes must not move the new ones
                self._promote.pop(k, None)

    def _note_access(self, keys: Sequence[Key]) -> None:
        promoters = [p for p in self.policies if p.kind == "promote"]
        with self._mu:
            for k in keys:
                m = self._meta.get(k)
                if m is None:
                    m = self._meta[k] = _Meta(self._clock())
                m.accesses += 1
                for p in promoters:
                    if m.accesses >= p.promote_after and p.applies(k):
                        tier = self.select.route(k)
                        if tier is not None and self._tier_name(tier) == p.from_tier:
                            self._promote.setdefault(k, p.to_tier)

    def _tier_name(self, tier: FDBClient) -> str:
        return self.select.tier_names[self.select.tiers.index(tier)]

    # -------------------------------------------------------------- pass-through
    def archive(self, key, data) -> None:
        key = self._as_key(key)
        self._note_archived([key])
        self.inner.archive(key, data)

    def archive_batch(self, items) -> None:
        items = [(self._as_key(k), d) for k, d in items]
        self._note_archived([k for k, _ in items])
        self.inner.archive_batch(items)

    def archive_fields(self, keys, fields, *, nbits=None) -> None:
        keys = [self._as_key(k) for k in keys]
        self._note_archived(keys)
        self.inner.archive_fields(keys, fields, nbits=nbits)

    def retrieve_batch(self, keys) -> list[DataHandle | None]:
        keys = [self._as_key(k) for k in keys]
        out = self.inner.retrieve_batch(keys)
        self._note_access([k for k, h in zip(keys, out) if h is not None])
        return out

    def flush(self) -> None:
        self.inner.flush()

    def drain(self) -> None:
        self.inner.drain()

    def _list(self, request: Request) -> Iterator[ListEntry]:
        return getattr(self.inner, "_list", self.inner.list)(request)

    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        report = self.inner._wipe_dataset(dataset_key, entries)
        ds_keys = self.schema.dataset_keys
        ds = self._as_key(dataset_key).subset(ds_keys)
        with self._mu:
            for k in [k for k in self._meta if k.subset(ds_keys) == ds]:
                del self._meta[k]
            for k in [k for k in self._promote if k.subset(ds_keys) == ds]:
                del self._promote[k]
        return report

    def io_stats(self) -> list:
        return self.inner.io_stats() + self._codec_sinks()

    def stats_snapshot(self) -> dict:
        snap = super().stats_snapshot()
        snap["lifecycle"] = self.lifecycle_snapshot()
        return snap

    # ---------------------------------------------------------------- migration
    def add_move_listener(self, fn: Callable[[list[Key]], None]) -> None:
        """``fn(keys)`` fires at each batch's flip — after the placement
        overlay swung to the destination, before the source copy is
        removed.  CacheFDB hooks here to invalidate moved keys."""
        self._listeners.append(fn)

    def _scan(
        self, now: float, limit: int | None
    ) -> tuple[list[tuple[Key, str, str, str]], int]:
        """Resolve policies to concrete moves:
        ``(key, src_name, dst_name, kind)``."""
        moves: list[tuple[Key, str, str, str]] = []
        with self._mu:
            promotions = list(self._promote.items())
            self._promote.clear()
            snapshot = [(k, m.archived_at, m.accesses) for k, m in self._meta.items()]
        queued: set[Key] = set()
        for k, dst in promotions:
            tier = self.select.route(k)
            if tier is not None and self._tier_name(tier) != dst:
                moves.append((k, self._tier_name(tier), dst, "promote"))
                queued.add(k)
        demoters = [p for p in self.policies if p.kind == "demote"]
        for k, archived_at, accesses in snapshot:
            if limit is not None and len(moves) >= limit:
                break
            if k in queued:
                continue
            tier = self.select.route(k)
            if tier is None:
                continue
            name = self._tier_name(tier)
            for p in demoters:
                if (
                    p.from_tier == name
                    and p.applies(k)
                    and p.due(age_s=now - archived_at, accesses=accesses)
                ):
                    moves.append((k, name, p.to_tier, "demote"))
                    break
        if limit is not None:
            moves = moves[:limit]
        return moves, len(snapshot)

    def _migrate_batch(
        self, keys: list[Key], src: FDBClient, dst: FDBClient, report: MigrationReport
    ) -> int:
        """Pin / copy / flip / remove one batch.  Returns fields moved."""
        tr = self._trace
        sel = self.select
        with tr.span("lifecycle.copy") as sp:
            # pin to the source FIRST: the copy we are about to catalogue on
            # dst must stay invisible until the flip
            for k in keys:
                sel.place(k, src)
            data = src.read_batch(keys)
            alive = [(k, d) for k, d in zip(keys, data) if d is not None]
            for k, d in zip(keys, data):
                if d is None:
                    # wiped underneath us between scan and copy: un-pin and
                    # forget — there is nothing to move
                    sel.clear_placement(k)
                    with self._mu:
                        self._meta.pop(k, None)
                    report.vanished += 1
            if alive:
                dst.archive_batch(alive)
                dst.flush()
            if tr.enabled:
                sp.set("n_fields", len(alive))
                sp.set("n_bytes", sum(len(d) for _, d in alive))
        if not alive:
            return 0
        moved = [k for k, _ in alive]
        with tr.span("lifecycle.flip") as sp:
            for k in moved:
                sel.place(k, dst)
            if tr.enabled:
                sp.set("n_fields", len(moved))
            for fn in self._listeners:
                fn(moved)
        with tr.span("lifecycle.wipe") as sp:
            removed = src._remove_fields(moved)
            if tr.enabled:
                sp.set("n_fields", removed)
        report.bytes_moved += sum(len(d) for _, d in alive)
        return len(moved)

    def run_once(self, *, max_fields: int | None = None) -> MigrationReport:
        """One engine cycle: scan policies, migrate every due field in
        batches.  Safe to call concurrently with foreground traffic; NOT
        re-entrant with itself (the background thread and manual calls must
        not overlap — ``start()`` owns the cycle when running)."""
        report = MigrationReport()
        tr = self._trace
        with tr.span("lifecycle.scan") as sp:
            now = self._clock()
            moves, report.scanned = self._scan(now, max_fields)
            if tr.enabled:
                sp.set("n_candidates", len(moves))
        groups: dict[tuple[str, str, str], list[Key]] = {}
        for k, src_name, dst_name, kind in moves:
            groups.setdefault((src_name, dst_name, kind), []).append(k)
        for (src_name, dst_name, kind), ks in groups.items():
            src = self.select.resolve_tier(src_name)
            dst = self.select.resolve_tier(dst_name)
            for i in range(0, len(ks), self._batch):
                n = self._migrate_batch(ks[i : i + self._batch], src, dst, report)
                report.batches += 1
                if kind == "promote":
                    report.promoted += n
                else:
                    report.demoted += n
        self._migrated_total += report.migrated
        return report

    def migrate_steps(self) -> Iterator[MigrationReport]:
        """Generator form of :meth:`run_once` — one batch per step.  The
        discrete-event hammer drives this so migration interleaves with
        foreground quanta on the virtual clock."""
        report = MigrationReport()
        with self._trace.span("lifecycle.scan"):
            moves, report.scanned = self._scan(self._clock(), None)
        groups: dict[tuple[str, str, str], list[Key]] = {}
        for k, src_name, dst_name, kind in moves:
            groups.setdefault((src_name, dst_name, kind), []).append(k)
        for (src_name, dst_name, kind), ks in groups.items():
            src = self.select.resolve_tier(src_name)
            dst = self.select.resolve_tier(dst_name)
            for i in range(0, len(ks), self._batch):
                step = MigrationReport(scanned=report.scanned)
                n = self._migrate_batch(ks[i : i + self._batch], src, dst, step)
                step.batches = 1
                if kind == "promote":
                    step.promoted = n
                else:
                    step.demoted = n
                self._migrated_total += step.migrated
                yield step

    # ----------------------------------------------------------- background
    def start(self, interval_s: float = 1.0) -> None:
        """Run the engine in a background thread every ``interval_s``."""
        if self._thread is not None:
            raise RuntimeError("lifecycle engine already running")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                self.run_once()

        self._thread = threading.Thread(target=loop, name="lifecycle-migrator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    # ------------------------------------------------------------- telemetry
    def lifecycle_snapshot(self) -> dict:
        with self._mu:
            tracked = len(self._meta)
            queued = len(self._promote)
        return {
            "tracked": tracked,
            "promote_queued": queued,
            "migrated_total": self._migrated_total,
            "overlay": self.select.overlay_snapshot(),
            "policies": [f"{p.kind}:{p.name}" for p in self.policies],
        }

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.stop()
        if self._owns_inner:
            self.inner.close()
        else:
            self.inner.flush()
