"""IOStats — the unified I/O telemetry protocol.

One accounting object subsumes the backend-specific stats (``DaosStats``,
``PosixStats`` are thin subclasses): per-op counts, per-op wall/virtual time,
per-op byte totals, per-shard (DAOS target / POSIX segment) op distribution,
and a fixed-bucket latency histogram per op (p50/p95/p99 without sampling).

Every mutation AND every read-out (``snapshot``/``reset``/``merge``) runs
under one internal lock, so a snapshot taken while other threads account is
always a consistent cut — byte totals, op counts and histograms agree with
each other.  (The seed's ``DaosStats`` kept its lock in the engine and
``snapshot()``/``reset()`` bypassed it; that race is fixed here.)

``snapshot()`` returns plain dicts ready for ``json.dumps``; ``to_json()``
is the one-call export used by the benchmarks.
"""

from __future__ import annotations

import json
import threading
from collections import Counter

from .histogram import LatencyHistogram

__all__ = ["IOStats"]


class IOStats:
    def __init__(self, name: str = ""):
        self.name = name
        self._mu = threading.RLock()
        self.ops: Counter = Counter()
        self.op_time: Counter = Counter()       # seconds per op name
        self.op_bytes_w: Counter = Counter()    # bytes written per op name
        self.op_bytes_r: Counter = Counter()    # bytes read per op name
        self.bytes_written = 0
        self.bytes_read = 0
        #: pre-codec (decoded) byte totals — what the application archived or
        #: consumed.  Equal to the wire totals on raw paths; larger on codec
        #: paths, where effective/wire is the compression win.
        self.effective_bytes_written = 0
        self.effective_bytes_read = 0
        self.shard_ops: Counter = Counter()     # DAOS target / POSIX segment
        #: named extra counters (e.g. PosixStats' lock_acquisitions /
        #: mds_ops) — merged and snapshotted generically so subclass
        #: telemetry survives IOStats.merged()
        self.counters: Counter = Counter()
        #: names of the sinks folded into this one — a merged snapshot used
        #: to drop the child identities entirely, making "which tier/lane
        #: fed this aggregate" unanswerable from the export
        self.merged_from: list[str] = []
        self._hist: dict[str, LatencyHistogram] = {}

    @property
    def lock(self) -> threading.RLock:
        """The stats lock — for compound read-modify-write sequences that
        must be atomic with respect to snapshot()/reset()."""
        return self._mu

    # ------------------------------------------------------------- recording
    def record(
        self,
        op: str,
        *,
        seconds: float | None = None,
        nbytes_w: int = 0,
        nbytes_r: int = 0,
        shard: int | str | None = None,
        count: int = 1,
        effective_w: int = 0,
        effective_r: int = 0,
    ) -> None:
        with self._mu:
            self._record_locked(
                op, seconds, nbytes_w, nbytes_r, shard, count, effective_w, effective_r
            )

    def _record_locked(
        self, op, seconds, nbytes_w, nbytes_r, shard, count,
        effective_w=0, effective_r=0,
    ) -> None:
        self.ops[op] += count
        if nbytes_w:
            self.bytes_written += nbytes_w
            self.op_bytes_w[op] += nbytes_w
        if nbytes_r:
            self.bytes_read += nbytes_r
            self.op_bytes_r[op] += nbytes_r
        if effective_w:
            self.effective_bytes_written += effective_w
        if effective_r:
            self.effective_bytes_read += effective_r
        if shard is not None:
            self.shard_ops[shard] += count
        if seconds is not None:
            self.op_time[op] += seconds
            h = self._hist.get(op)
            if h is None:
                h = self._hist[op] = LatencyHistogram()
            h.record(seconds, count)

    def record_burst(self, records) -> None:
        """Account many ``(op, kwargs)`` records under ONE lock round — the
        accounting analogue of the backends' batched I/O paths."""
        with self._mu:
            for op, kw in records:
                self._record_locked(
                    op,
                    kw.get("seconds"),
                    kw.get("nbytes_w", 0),
                    kw.get("nbytes_r", 0),
                    kw.get("shard"),
                    kw.get("count", 1),
                    kw.get("effective_w", 0),
                    kw.get("effective_r", 0),
                )

    # --------------------------------------------------------------- reading
    def snapshot(self) -> dict:
        with self._mu:
            snap = {
                "ops": dict(self.ops),
                "op_time": dict(self.op_time),
                "op_bytes_w": dict(self.op_bytes_w),
                "op_bytes_r": dict(self.op_bytes_r),
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "effective_bytes_written": self.effective_bytes_written,
                "effective_bytes_read": self.effective_bytes_read,
                "shard_ops": {str(k): v for k, v in self.shard_ops.items()},
                "counters": dict(self.counters),
                "latency": {op: h.snapshot() for op, h in sorted(self._hist.items())},
            }
            if self.name:
                snap["name"] = self.name
            if self.merged_from:
                snap["merged_from"] = list(self.merged_from)
            return snap

    def latency(self, op: str) -> LatencyHistogram | None:
        with self._mu:
            h = self._hist.get(op)
            return h.copy() if h is not None else None

    def reset(self) -> None:
        with self._mu:
            self.ops.clear()
            self.op_time.clear()
            self.op_bytes_w.clear()
            self.op_bytes_r.clear()
            self.bytes_written = 0
            self.bytes_read = 0
            self.effective_bytes_written = 0
            self.effective_bytes_read = 0
            self.shard_ops.clear()
            self.counters.clear()
            self.merged_from.clear()
            self._hist.clear()

    def merge(self, other: "IOStats") -> None:
        """Fold *other* into self (both consistently cut)."""
        with other._mu:
            o_ops = Counter(other.ops)
            o_time = Counter(other.op_time)
            o_bw = Counter(other.op_bytes_w)
            o_br = Counter(other.op_bytes_r)
            o_w, o_r = other.bytes_written, other.bytes_read
            o_ew, o_er = other.effective_bytes_written, other.effective_bytes_read
            o_shards = Counter(other.shard_ops)
            o_counters = Counter(other.counters)
            # a merged child contributes its own sources, a leaf its name —
            # so nested merges flatten to the full provenance list
            o_sources = list(other.merged_from) or (
                [other.name] if other.name else []
            )
            o_hist = {op: h.copy() for op, h in other._hist.items()}
        with self._mu:
            self.ops.update(o_ops)
            self.op_time.update(o_time)
            self.op_bytes_w.update(o_bw)
            self.op_bytes_r.update(o_br)
            self.bytes_written += o_w
            self.bytes_read += o_r
            self.effective_bytes_written += o_ew
            self.effective_bytes_read += o_er
            self.shard_ops.update(o_shards)
            self.counters.update(o_counters)
            for src in o_sources:
                if src not in self.merged_from:
                    self.merged_from.append(src)
            for op, h in o_hist.items():
                mine = self._hist.get(op)
                if mine is None:
                    self._hist[op] = h
                else:
                    mine.merge(h)

    @classmethod
    def merged(cls, stats_list, name: str = "merged") -> "IOStats":
        out = cls(name)
        for s in stats_list:
            out.merge(s)
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)
