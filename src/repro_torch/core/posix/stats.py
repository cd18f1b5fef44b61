"""Accounting for the POSIX backend's file-system operations.

On a real Lustre deployment every conflicting write/read implies LDLM lock
round-trips between clients and lock servers, and every open/stat implies
MDS round-trips (paper §1: "distributed locking mechanisms need to be put in
place ... causing large lock communication overheads on the client nodes").
A local filesystem has none of those costs, so the backend *counts* the
operations that would incur them; the benchmark cost model
(:mod:`repro.core.costmodel`) converts counts into simulated time at scale,
and the contention model (:mod:`repro.metrics.contention`) injects them as
per-op latencies.

:class:`PosixStats` is the :class:`~repro.metrics.IOStats` protocol plus the
two Lustre-specific counters (extent locks, MDS round-trips).  Snapshot and
reset are atomic with respect to concurrent accounting — all state lives
under the one IOStats lock.
"""

from __future__ import annotations

from ...metrics.iostats import IOStats

__all__ = ["PosixStats", "POSIX_STATS"]


class PosixStats(IOStats):
    """The Lustre counters live in the generic ``counters`` map, so they
    survive :meth:`IOStats.merge`/``merged`` (e.g. in ``stats_snapshot()``
    across router lanes); the properties and top-level snapshot keys are the
    POSIX-flavoured view of them."""

    def __init__(self, name: str = "posix"):
        super().__init__(name)

    def account(
        self,
        op: str,
        *,
        nbytes_w: int = 0,
        nbytes_r: int = 0,
        locks: int = 0,
        mds: int = 0,
        seconds: float | None = None,
        shard: str | None = None,
    ) -> None:
        with self._mu:
            self._record_locked(op, seconds, nbytes_w, nbytes_r, shard, 1)
            # extent locks a Lustre client would need + MDS round-trips
            if locks:
                self.counters["lock_acquisitions"] += locks
            if mds:
                self.counters["mds_ops"] += mds

    @property
    def lock_acquisitions(self) -> int:
        return self.counters["lock_acquisitions"]

    @property
    def mds_ops(self) -> int:
        return self.counters["mds_ops"]

    def snapshot(self) -> dict:
        with self._mu:  # RLock: the nested snapshot stays one atomic cut
            snap = super().snapshot()
            snap["lock_acquisitions"] = self.counters["lock_acquisitions"]
            snap["mds_ops"] = self.counters["mds_ops"]
            return snap


#: process-global stats instance (one "client" per process) — the default
#: sink; pass ``stats=PosixStats(...)`` to the backends for per-lane
#: telemetry instead
POSIX_STATS = PosixStats()
