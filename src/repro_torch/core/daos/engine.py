"""The DAOS engine — the server side of the emulation.

Exposes a flat RPC-style API mirroring the libdaos calls the FDB backends
use.  Every call is accounted in :class:`DaosStats` (op counts, bytes moved,
per-target distribution, latency histograms) — the benchmark cost model
replays these counters through the latency model to produce the paper's
scaling curves, and the profiling benchmark (paper Fig. 5) groups wall-time
by these op names.

With a :class:`~repro.metrics.DaosContention` model attached, each op is
additionally charged its scale-faithful service time at its target's queue
(metadata spread over all engines, MVCC contention resolved server-side),
and batched multi-ops overlap their per-target services under a single
event-queue drain (paper §3.1.2).

Thread-safe; also servable over a Unix socket for true multi-process
contention tests (:mod:`repro.core.daos.server`).
"""

from __future__ import annotations

import threading
import time

from ...metrics.iostats import IOStats
from .objects import OC_S1, ArrayObject, KVObject, ObjectId, hash_dkey_to_target
from .pool import Container, Pool

__all__ = ["DaosEngine", "DaosStats", "DaosError", "ENOENT", "EEXIST"]

ENOENT = 2
EEXIST = 17


class DaosError(OSError):
    def __init__(self, errno_: int, msg: str):
        super().__init__(errno_, msg)


class DaosStats(IOStats):
    """DAOS-flavoured :class:`IOStats`: the per-shard distribution is the
    per-*target* op count.  snapshot()/reset() are atomic with respect to
    concurrent accounting (both run under the stats lock — the seed kept the
    lock in the engine and bypassed it here)."""

    def __init__(self, name: str = "daos"):
        super().__init__(name)

    @property
    def target_ops(self):
        return self.shard_ops

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["target_ops"] = {int(k): v for k, v in snap.pop("shard_ops").items()}
        return snap


class DaosEngine:
    """One emulated DAOS system (any number of engines/targets).

    ``n_engines`` × ``targets_per_engine`` gives the target count used for
    dkey placement accounting (paper test system: 2 engines/node, 12
    targets/engine).  ``contention`` (a
    :class:`~repro.metrics.DaosContention`) makes every op cost its at-scale
    service time on the caller's clock.
    """

    def __init__(self, n_engines: int = 2, targets_per_engine: int = 12, *, contention=None):
        self.n_engines = n_engines
        self.targets_per_engine = targets_per_engine
        self._pools: dict[str, Pool] = {}
        self._mu = threading.Lock()
        self.stats = DaosStats()
        self.contention = contention

    # ------------------------------------------------------------------ util
    @property
    def n_targets(self) -> int:
        return self.n_engines * self.targets_per_engine

    def _target(self, dkey: str | None) -> int | None:
        return None if dkey is None else hash_dkey_to_target(dkey, self.n_targets)

    def _account(
        self,
        op: str,
        *,
        dkey: str | None = None,
        nbytes_w: int = 0,
        nbytes_r: int = 0,
        dt: float = 0.0,
    ) -> None:
        target = self._target(dkey)
        if self.contention is not None:
            # the emulated at-scale latency REPLACES the wall time: telemetry
            # stays scale-faithful and deterministic under the virtual clock
            dt = self.contention.op(op, target, nbytes_w, nbytes_r)
        self.stats.record(op, seconds=dt, nbytes_w=nbytes_w, nbytes_r=nbytes_r, shard=target)

    # ------------------------------------------------------------- pool mgmt
    def create_pool(self, label: str, *, exist_ok: bool = True) -> Pool:
        with self._mu:
            if label in self._pools:
                if exist_ok:
                    return self._pools[label]
                raise DaosError(EEXIST, f"pool {label!r} exists")
            pool = Pool(label, n_targets=self.n_targets)
            self._pools[label] = pool
            return pool

    def pool_connect(self, label: str) -> Pool:
        t0 = time.perf_counter()
        pool = self._pools.get(label)
        if pool is None:
            raise DaosError(ENOENT, f"pool {label!r} not found")
        self._account("daos_pool_connect", dt=time.perf_counter() - t0)
        return pool

    # -------------------------------------------------------------- cont mgmt
    def cont_create(self, pool: str, label: str, *, exist_ok: bool = True) -> str:
        t0 = time.perf_counter()
        p = self._pools[pool]
        try:
            p.create_container(label, exist_ok=exist_ok)
        except FileExistsError as e:
            raise DaosError(EEXIST, str(e)) from e
        self._account("daos_cont_create", dt=time.perf_counter() - t0)
        return label

    def cont_open(self, pool: str, label: str) -> str:
        t0 = time.perf_counter()
        p = self._pools[pool]
        if not p.has_container(label):
            raise DaosError(ENOENT, f"container {label!r} not found in pool {pool!r}")
        self._account("daos_cont_open", dt=time.perf_counter() - t0)
        return label

    def cont_exists(self, pool: str, label: str) -> bool:
        return self._pools[pool].has_container(label)

    def cont_destroy(self, pool: str, label: str) -> None:
        t0 = time.perf_counter()
        self._pools[pool].destroy_container(label, missing_ok=True)
        self._account("daos_cont_destroy", dt=time.perf_counter() - t0)

    def cont_list(self, pool: str) -> list[str]:
        return self._pools[pool].list_containers()

    def cont_alloc_oids(self, pool: str, cont: str, count: int) -> int:
        """``daos_cont_alloc_oids`` — returns the base of a contiguous range.
        Clients pre-allocate and cache ranges (paper §3.1.2)."""
        t0 = time.perf_counter()
        base = self._cont(pool, cont).alloc_oids(count)
        self._account("daos_cont_alloc_oids", dkey=f"{cont}/__oids__", dt=time.perf_counter() - t0)
        return base

    def _cont(self, pool: str, cont: str) -> Container:
        p = self._pools.get(pool)
        if p is None:
            raise DaosError(ENOENT, f"pool {pool!r} not found")
        try:
            return p.open_container(cont)
        except FileNotFoundError as e:
            raise DaosError(ENOENT, str(e)) from e

    # ---------------------------------------------------------------- KV API
    def kv_put(self, pool: str, cont: str, oid: ObjectId, key: str, value: bytes, *, oclass: str = OC_S1) -> None:
        t0 = time.perf_counter()
        kv = self._cont(pool, cont).open_kv(oid, create=True, oclass=oclass)
        kv.put(key, value)
        self._account("daos_kv_put", dkey=f"{cont}/{oid}/{key}", nbytes_w=len(value), dt=time.perf_counter() - t0)

    def kv_get(self, pool: str, cont: str, oid: ObjectId, key: str) -> bytes | None:
        t0 = time.perf_counter()
        try:
            kv = self._cont(pool, cont).open_kv(oid, create=False)
        except KeyError:
            self._account("daos_kv_get", dkey=f"{cont}/{oid}/{key}", dt=time.perf_counter() - t0)
            return None
        v = kv.get(key)
        self._account(
            "daos_kv_get", dkey=f"{cont}/{oid}/{key}", nbytes_r=0 if v is None else len(v), dt=time.perf_counter() - t0
        )
        return v

    def kv_remove(self, pool: str, cont: str, oid: ObjectId, key: str) -> None:
        t0 = time.perf_counter()
        try:
            kv = self._cont(pool, cont).open_kv(oid, create=False)
        except KeyError:
            return
        kv.remove(key)
        self._account("daos_kv_remove", dkey=f"{cont}/{oid}/{key}", dt=time.perf_counter() - t0)

    def kv_list(self, pool: str, cont: str, oid: ObjectId) -> list[str]:
        t0 = time.perf_counter()
        try:
            kv = self._cont(pool, cont).open_kv(oid, create=False)
        except KeyError:
            self._account("daos_kv_list", dt=time.perf_counter() - t0)
            return []
        keys = kv.list_keys()
        self._account("daos_kv_list", dkey=f"{cont}/{oid}", dt=time.perf_counter() - t0)
        return keys

    # ---------------------------------------------------------- event queues
    def eq_poll(self, n_events: int = 1) -> None:
        """``daos_eq_poll`` — drain a client event queue after a burst of
        non-blocking ops.  The emulated ops above complete synchronously, so
        this only *accounts* the single drain a batched client pays in place
        of per-op completion waits (paper §3.1.2: many small I/Os in flight,
        one completion round per batch)."""
        self._account("daos_eq_poll", dt=0.0)
        del n_events

    # ------------------------------------------------------------- multi ops
    # A burst of non-blocking ops + one eq_poll is the DAOS client's batched
    # I/O idiom; the multi calls below are that burst as ONE engine round —
    # per-op work still accounted per op, but the client pays a single
    # round-trip (here: one accounting/lock round) for the whole batch.
    # Under contention, the burst's per-target services overlap and the one
    # completion drain carries the burst latency.

    def _account_burst(self, burst, dt: float) -> None:
        """Account a list of ``(op, dkey, nbytes_w, nbytes_r)`` completed by
        one event-queue drain."""
        targeted = [(op, self._target(dkey), nw, nr) for op, dkey, nw, nr in burst]
        if self.contention is not None:
            dt = self.contention.burst(targeted)  # replaces wall time
        records = [
            (op, {"nbytes_w": nw, "nbytes_r": nr, "shard": target})
            for op, target, nw, nr in targeted
        ]
        # the drain is where a batched client actually waits: the burst's
        # overlapped completion latency lands on its histogram
        records.append(("daos_eq_poll", {"seconds": dt}))
        self.stats.record_burst(records)

    def array_write_multi(self, pool: str, cont: str, writes, *, cell_size: int = 1, chunk_size: int = 1 << 20, oclass: str = OC_S1) -> None:
        """Burst of ``(oid, offset, data)`` open-with-attrs + writes,
        completed by one event-queue drain."""
        t0 = time.perf_counter()
        c = self._cont(pool, cont)
        burst = []
        for oid, offset, data in writes:
            arr = c.open_array_with_attrs(oid, cell_size=cell_size, chunk_size=chunk_size, oclass=oclass)
            arr.write(offset, data)
            burst.append(("daos_array_open_with_attrs", f"{cont}/{oid}", 0, 0))
            burst.append(("daos_array_write", f"{cont}/{oid}", len(data), 0))
        self._account_burst(burst, time.perf_counter() - t0)

    def kv_put_multi(self, pool: str, cont: str, puts, *, oclass: str = OC_S1) -> None:
        """Burst of ``(oid, key, value)`` transactional inserts, one drain."""
        t0 = time.perf_counter()
        c = self._cont(pool, cont)
        burst = []
        for oid, key, value in puts:
            c.open_kv(oid, create=True, oclass=oclass).put(key, value)
            burst.append(("daos_kv_put", f"{cont}/{oid}/{key}", len(value), 0))
        self._account_burst(burst, time.perf_counter() - t0)

    def kv_get_multi(self, pool: str, cont: str, gets) -> list:
        """Burst of ``(oid, key)`` lookups, one drain; absent keys -> None."""
        t0 = time.perf_counter()
        try:
            c = self._cont(pool, cont)
        except DaosError:
            c = None
        out: list = []
        burst = []
        for oid, key in gets:
            v = None
            if c is not None:
                try:
                    v = c.open_kv(oid, create=False).get(key)
                except KeyError:
                    v = None
            out.append(v)
            burst.append(("daos_kv_get", f"{cont}/{oid}/{key}", 0, 0 if v is None else len(v)))
        self._account_burst(burst, time.perf_counter() - t0)
        return out

    # -------------------------------------------------------------- Array API
    def array_create(self, pool: str, cont: str, oid: ObjectId, *, cell_size: int = 1, chunk_size: int = 1 << 20, oclass: str = OC_S1) -> None:
        t0 = time.perf_counter()
        try:
            self._cont(pool, cont).create_array(oid, oclass=oclass, cell_size=cell_size, chunk_size=chunk_size)
        except FileExistsError as e:
            raise DaosError(EEXIST, str(e)) from e
        self._account("daos_array_create", dkey=f"{cont}/{oid}", dt=time.perf_counter() - t0)

    def array_open_with_attrs(self, pool: str, cont: str, oid: ObjectId, *, cell_size: int = 1, chunk_size: int = 1 << 20, oclass: str = OC_S1) -> None:
        t0 = time.perf_counter()
        self._cont(pool, cont).open_array_with_attrs(oid, cell_size=cell_size, chunk_size=chunk_size, oclass=oclass)
        self._account("daos_array_open_with_attrs", dkey=f"{cont}/{oid}", dt=time.perf_counter() - t0)

    def array_write(self, pool: str, cont: str, oid: ObjectId, offset: int, data: bytes) -> None:
        t0 = time.perf_counter()
        try:
            arr = self._cont(pool, cont).open_array(oid)
        except FileNotFoundError:
            # open_with_attrs-style lazy creation
            arr = self._cont(pool, cont).open_array_with_attrs(oid)
        arr.write(offset, data)
        self._account("daos_array_write", dkey=f"{cont}/{oid}", nbytes_w=len(data), dt=time.perf_counter() - t0)

    def array_read(self, pool: str, cont: str, oid: ObjectId, offset: int = 0, length: int | None = None) -> bytes:
        t0 = time.perf_counter()
        try:
            arr = self._cont(pool, cont).open_array(oid)
        except FileNotFoundError as e:
            raise DaosError(ENOENT, str(e)) from e
        data = arr.read(offset, length)
        self._account("daos_array_read", dkey=f"{cont}/{oid}", nbytes_r=len(data), dt=time.perf_counter() - t0)
        return data

    def array_get_size(self, pool: str, cont: str, oid: ObjectId) -> int:
        t0 = time.perf_counter()
        try:
            arr = self._cont(pool, cont).open_array(oid)
        except FileNotFoundError as e:
            raise DaosError(ENOENT, str(e)) from e
        n = arr.get_size()
        self._account("daos_array_get_size", dkey=f"{cont}/{oid}", dt=time.perf_counter() - t0)
        return n

    def obj_punch(self, pool: str, cont: str, oid: ObjectId) -> bool:
        """``daos_obj_punch`` — drop one object (any type) and its extents.
        Idempotent: punching a missing object is False, not an error (the
        lifecycle migrator may race a dataset wipe)."""
        t0 = time.perf_counter()
        try:
            existed = self._cont(pool, cont).destroy_object(oid)
        except DaosError:
            existed = False  # container already destroyed underneath us
        self._account("daos_obj_punch", dkey=f"{cont}/{oid}", dt=time.perf_counter() - t0)
        return existed
