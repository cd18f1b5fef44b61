"""Pluggable contention emulation: deterministic service-time injection.

The emulated backends complete every op at memory speed, so a laptop run
cannot exhibit the paper's central result — POSIX/Lustre per-client
bandwidth collapsing under shared-file extent-lock contention while DAOS
keeps scaling across targets (§4; companion paper arXiv:2211.09162).  A
:class:`ContentionModel` closes that gap: the backends report every
operation to the model, which computes the latency that operation would
have cost on the paper's test system (NEXTGenIO, §4.1) using the calibrated
constants in :mod:`repro.core.costmodel`, and charges it to a clock.

Mechanics — a timeline-queueing service model:

- every shared service centre (a Lustre OST stream, the per-file extent-lock
  queue, the single MDS, a DAOS target) is a *resource* owning a timeline of
  busy intervals;
- an op arriving at virtual time ``t`` with service time ``s`` occupies the
  EARLIEST idle gap of length ``s`` at or after ``t`` — concurrent clients
  queue, idle resources don't charge, and an op dispatched out of arrival
  order (clients interleave at whole-operation granularity) back-fills the
  gap it would truly have used instead of queueing behind reservations made
  for later arrivals;
- each client additionally pays *serial* client-side time (per-process
  protocol ceiling, round-trips) that no other client shares;
- a burst (DAOS non-blocking ops + one ``eq_poll``; a POSIX vectored write)
  dispatches all its resource ops at the same instant — they overlap across
  resources and the client pays ``max``, not ``sum`` (paper §3.1.2).

Clock modes:

- **virtual** (default): nothing sleeps; each client owns a
  :class:`ClientClock` that the model advances.  Tests and sweeps run at
  memory speed yet report scale-faithful times — and, driven by the
  deterministic earliest-clock-first scheduler in
  ``benchmarks/fdb_hammer.py``, bit-identical numbers on every run;
- **wall**: the computed latency is actually slept (scaled by
  ``sleep_scale``), for observing real thread interleavings under load.

Backends treat the model as optional: ``None`` keeps the seed behaviour.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from repro_torch.core.costmodel import (
    CACHE_BW_Bps,
    CACHE_HIT_S,
    DEFAULT_DAOS,
    DEFAULT_LUSTRE,
    DaosCosts,
    LustreCosts,
)

__all__ = [
    "ClientClock",
    "ContentionModel",
    "LustreContention",
    "DaosContention",
    "make_contention",
]


class ClientClock:
    """Per-client virtual time (seconds since the model's epoch)."""

    __slots__ = ("name", "t")

    def __init__(self, name: str = ""):
        self.name = name
        self.t = 0.0


class _Timeline:
    """Busy intervals of one resource; gap-filling (earliest-fit) insertion.

    ``reserve(arrival, service)`` returns the interval actually occupied.
    Intervals ending before the pruning horizon (no live client can dispatch
    into the past) are dropped, keeping the list short."""

    __slots__ = ("intervals",)

    def __init__(self):
        self.intervals: list[list[float]] = []  # sorted disjoint [start, end)

    def reserve(self, arrival: float, service: float) -> tuple[float, float]:
        if service <= 0.0:
            return arrival, arrival
        t = arrival
        at = len(self.intervals)
        for i, (s, e) in enumerate(self.intervals):
            if e <= t:
                continue
            if s - t >= service:  # the gap before this interval fits
                at = i
                break
            t = e  # overlaps or gap too small: try after this interval
        end = t + service
        # insert, coalescing with touching neighbours to bound list growth
        if at > 0 and self.intervals[at - 1][1] == t:
            self.intervals[at - 1][1] = end
            if at < len(self.intervals) and self.intervals[at][0] == end:
                self.intervals[at - 1][1] = self.intervals[at][1]
                del self.intervals[at]
        elif at < len(self.intervals) and self.intervals[at][0] == end:
            self.intervals[at][0] = t
        else:
            self.intervals.insert(at, [t, end])
        return t, end

    def prune(self, horizon: float) -> None:
        keep = 0
        for s, e in self.intervals:
            if e > horizon:
                break
            keep += 1
        if keep:
            del self.intervals[:keep]


class ContentionModel:
    """Base model: resource timelines + client clocks.  Subclasses translate
    backend operations into ``(resource, service_s)`` dispatches."""

    def __init__(self, *, virtual: bool = True, sleep_scale: float = 1.0):
        self.virtual = virtual
        self.sleep_scale = sleep_scale
        self._mu = threading.Lock()
        self._timelines: dict[str, _Timeline] = {}
        self._tls = threading.local()
        self._epoch = time.perf_counter()
        self._anon = 0

    # ------------------------------------------------------------- clients
    def new_client(self, name: str = "") -> ClientClock:
        with self._mu:
            self._anon += 1
            return ClientClock(name or f"client{self._anon}")

    @contextmanager
    def bind(self, client: ClientClock):
        """Attach *client* to the current thread for the duration — every op
        the thread reports is charged to this client's clock."""
        prev = getattr(self._tls, "client", None)
        self._tls.client = client
        try:
            yield client
        finally:
            self._tls.client = prev

    def client(self) -> ClientClock:
        c = getattr(self._tls, "client", None)
        if c is None:  # unbound thread: one ambient client per thread
            c = self.new_client(f"thread-{threading.get_ident()}")
            self._tls.client = c
        return c

    # ------------------------------------------------------------ dispatch
    def submit(self, shared, client_s: float = 0.0) -> float:
        """Charge ``client_s`` of serial client time, then dispatch every
        ``(resource, service_s)`` in *shared* at the same instant (they
        overlap across resources, queue within one).  Returns the injected
        latency and advances the bound client's clock by it."""
        c = self.client()
        with self._mu:
            t0 = c.t if self.virtual else time.perf_counter() - self._epoch
            start = t0 + client_s
            end = start
            for resource, service_s in shared:
                tl = self._timelines.get(resource)
                if tl is None:
                    tl = self._timelines[resource] = _Timeline()
                _, done = tl.reserve(start, service_s)
                if done > end:
                    end = done
            latency = end - t0
            c.t += latency
        if not self.virtual and latency > 0.0:
            time.sleep(latency * self.sleep_scale)
        return latency

    def cache_hit(self, nbytes: int) -> float:
        """The cache tier of the model: a read served from the client-side
        dissemination cache (:mod:`repro.cache`) touches NO shared service
        centre — the client pays only a fixed lookup plus its local DRAM
        copy time.  This is exactly why the read-side knee moves right in
        ``fdb_hammer --scaling``: hits take this path instead of queueing
        at the lock/OST/engine timelines."""
        return self.submit([], CACHE_HIT_S + nbytes / CACHE_BW_Bps)

    def prune(self, horizon: float) -> None:
        """Drop busy intervals ending before *horizon* (call with the
        minimum live client clock — nothing can dispatch into the past)."""
        with self._mu:
            for tl in self._timelines.values():
                tl.prune(horizon)

    def reset(self) -> None:
        with self._mu:
            self._timelines.clear()
            self._epoch = time.perf_counter()


class LustreContention(ContentionModel):
    """POSIX backend on Lustre (paper §2): per-file extent-lock queues that
    serialise concurrent writers, a single metadata server, per-OST data
    streams, and a per-process protocol ceiling on the client."""

    def __init__(self, costs: LustreCosts = DEFAULT_LUSTRE, **kw):
        super().__init__(**kw)
        self.costs = costs
        self._writers: dict[str, set[str]] = {}  # segment -> registered writers

    # conflict probability grows with the number of opposing lock holders on
    # the same file (paper §2: blocking ASTs + cache invalidation)
    def _conflict_s(self, n_holders: int) -> float:
        if n_holders <= 1:
            return 0.0
        p = min(1.0, self.costs.conflict_base * (n_holders - 1) / 8.0)
        return p * (self.costs.lock_cancel_s + self.costs.lock_rtt_s)

    def _register_writer(self, segment: str) -> int:
        name = self.client().name
        with self._mu:
            holders = self._writers.setdefault(segment, set())
            holders.add(name)
            return len(holders)

    def _holders(self, segment: str) -> int:
        with self._mu:
            return len(self._writers.get(segment, ()))

    # ------------------------------------------------------------ op costs
    def write(self, segment: str, nbytes: int, *, nfields: int = 1) -> float:
        """An (optionally vectored) append of *nbytes* to *segment*: one
        extent-lock enqueue for the whole run + the OST data service; the
        client pays its protocol-ceiling transfer time."""
        c = self.costs
        k = self._register_writer(segment)
        lock_s = c.lock_rtt_s + self._conflict_s(k)
        shared = [
            (f"lock:{segment}", lock_s),
            (f"ost:{segment}", nbytes / c.ost_bw_Bps),
        ]
        return self.submit(shared, c.rtt_s + nbytes / c.per_proc_bw_Bps)

    def read(self, segment: str, nbytes: int) -> float:
        """A read crossing another process's stream: read-lock enqueue that
        conflicts with any cached write locks, then a derated (seeky) OST
        read (paper §5.3 (b))."""
        c = self.costs
        k = self._holders(segment)
        lock_s = c.lock_rtt_s + self._conflict_s(k + 1)
        shared = [
            (f"lock:{segment}", lock_s),
            (f"ost:{segment}", nbytes / (c.ost_bw_Bps * c.read_bw_derate)),
        ]
        return self.submit(shared, c.rtt_s + nbytes / c.per_proc_bw_Bps)

    def mds(self, n_ops: int = 1) -> float:
        """open/create/stat/readdir: serialised on the single MDS node."""
        return self.submit([("mds", n_ops * self.costs.mds_op_s)], self.costs.rtt_s)

    def sync(self) -> float:
        """fsync: dirty pages were charged at write time; one round-trip."""
        return self.submit([], self.costs.rtt_s)


class DaosContention(ContentionModel):
    """DAOS backend (paper §2/§3): metadata and data spread over per-engine
    targets, MVCC resolving contention server-side (no client lock
    round-trips), TCP round-trips, per-process protocol ceiling."""

    _KV_OPS = frozenset(
        {"daos_kv_put", "daos_kv_get", "daos_kv_remove", "daos_cont_alloc_oids"}
    )
    _FREE_OPS = frozenset({"daos_eq_poll"})  # completion drain: client rtt only

    def __init__(self, costs: DaosCosts = DEFAULT_DAOS, *, targets_per_engine: int = 12, **kw):
        super().__init__(**kw)
        self.costs = costs
        self.target_bw_Bps = costs.engine_bw_Bps / max(1, targets_per_engine)

    def _service_s(self, op: str, nbytes: int) -> float:
        c = self.costs
        if op in self._FREE_OPS:
            return 0.0
        base = c.kv_op_s if op in self._KV_OPS else c.array_op_s
        if op == "daos_kv_list":
            base *= 4.0  # index visit walks the KV tree
        return base + nbytes / self.target_bw_Bps

    def op(self, op: str, target: int | None, nbytes_w: int = 0, nbytes_r: int = 0) -> float:
        """One synchronous client round: TCP rtt + protocol-ceiling transfer
        on the client, service queueing at the op's target."""
        nbytes = nbytes_w + nbytes_r
        shared = []
        service = self._service_s(op, nbytes)
        if target is not None and service > 0.0:
            shared.append((f"tgt:{target}", service))
        return self.submit(shared, self.costs.rtt_s + nbytes / self.costs.per_proc_bw_Bps)

    def burst(self, ops) -> float:
        """A burst of non-blocking ``(op, target, nbytes_w, nbytes_r)``
        completed by one ``eq_poll``: the client pays ONE round-trip and the
        total transfer; the per-op services overlap across targets and only
        queue within each target (paper §3.1.2)."""
        total = 0
        shared = []
        for op, target, nw, nr in ops:
            total += nw + nr
            service = self._service_s(op, nw + nr)
            if target is not None and service > 0.0:
                shared.append((f"tgt:{target}", service))
        return self.submit(shared, self.costs.rtt_s + total / self.costs.per_proc_bw_Bps)


def make_contention(
    backend: str,
    *,
    virtual: bool = True,
    sleep_scale: float = 1.0,
    lustre: LustreCosts = DEFAULT_LUSTRE,
    daos: DaosCosts = DEFAULT_DAOS,
    targets_per_engine: int = 12,
):
    """Factory: ``backend in {'posix', 'lustre', 'daos'}`` -> model."""
    if backend in ("posix", "lustre"):
        return LustreContention(lustre, virtual=virtual, sleep_scale=sleep_scale)
    if backend == "daos":
        return DaosContention(
            daos, targets_per_engine=targets_per_engine, virtual=virtual, sleep_scale=sleep_scale
        )
    raise ValueError(f"unknown contention backend {backend!r}")
