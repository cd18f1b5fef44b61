"""Fixed-bucket latency histograms.

Log-spaced buckets (8 per decade) spanning 100 ns .. 1000 s cover every
latency this codebase can produce — from sub-microsecond in-memory ops to
multi-second simulated phases — with a relative quantile error bounded by
the bucket ratio (10^(1/8) ≈ 1.33).  Fixed buckets make histograms mergeable
across ops, lanes and processes without rebinning, and percentile reads are
deterministic functions of the counts (no sampling).

Instances are NOT thread-safe on their own; :class:`repro.metrics.IOStats`
guards them with its stats lock.
"""

from __future__ import annotations

import math

__all__ = ["LatencyHistogram"]

_LO = 1e-7                      # smallest resolved latency: 100 ns
_PER_DECADE = 8
_DECADES = 10                   # 1e-7 .. 1e3 s
_NBUCKETS = _PER_DECADE * _DECADES + 2  # + underflow + overflow


def _bucket_upper(i: int) -> float:
    """Upper bound of bucket *i* (1-based interior buckets)."""
    return _LO * 10.0 ** (i / _PER_DECADE)


class LatencyHistogram:
    __slots__ = ("counts", "n", "total_s", "min_s", "max_s")

    def __init__(self):
        self.counts = [0] * _NBUCKETS
        self.n = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    # ------------------------------------------------------------- recording
    @staticmethod
    def _index(seconds: float) -> int:
        if seconds < _LO:
            return 0  # underflow
        i = int(math.log10(seconds / _LO) * _PER_DECADE) + 1
        return min(i, _NBUCKETS - 1)  # clamp to overflow bucket

    def record(self, seconds: float, count: int = 1) -> None:
        seconds = max(0.0, float(seconds))
        self.counts[self._index(seconds)] += count
        self.n += count
        self.total_s += seconds * count
        if seconds < self.min_s:
            self.min_s = seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total_s += other.total_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)

    # --------------------------------------------------------------- reading
    def percentile(self, q: float) -> float:
        """Latency at quantile ``q`` in [0, 1] (bucket upper bound, clamped
        to the observed range).  0.0 when the histogram is empty.

        The rank is the 1-based index of the sample the quantile lands on:
        ``ceil(q * n)``, floored at 1.  A fractional rank would let
        ``seen >= rank`` fire a bucket early (p50 of three samples is the
        2nd-ranked one, not wherever 1.5 first crosses), and the low edge
        reports the observed minimum, not the ``_LO`` bucket bound."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.n))
        if rank == 1:
            # the lowest-ranked sample is the observed minimum, exactly
            return self.min_s
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i == 0:
                    # underflow bucket: below _LO resolution, min_s is the
                    # only honest answer
                    return self.min_s
                if i == _NBUCKETS - 1:  # overflow: the observed max is all we know
                    return self.max_s
                return min(_bucket_upper(i), self.max_s)
        return self.max_s

    @property
    def mean_s(self) -> float:
        return self.total_s / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.n,
            "total_s": self.total_s,
            "mean_s": self.mean_s,
            "min_s": 0.0 if self.n == 0 else self.min_s,
            "max_s": self.max_s,
            "p50_s": self.percentile(0.50),
            "p95_s": self.percentile(0.95),
            "p99_s": self.percentile(0.99),
        }

    def copy(self) -> "LatencyHistogram":
        h = LatencyHistogram()
        h.merge(self)
        return h
