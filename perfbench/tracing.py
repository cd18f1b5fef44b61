"""The benchmark's own spans, and the reduction of the profiler's device trace.

Spans are (name, start, end) on the host's wall clock in nanoseconds
(``time.time_ns``), the clock ``torch.profiler`` stamps its events with, so
a device event and a span can be laid side by side.  The device trace is
``torch.profiler`` with CUDA activity alone: every kernel, copy and fill the
card ran.  :func:`reduce_trace` turns its events into the time the card was
busy (the union of those events in the window), time by operation, and the
idle time, by the benchmark span that was open while the card idled.
"""

from __future__ import annotations

import bisect
import contextlib
import time

TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # a kernel's name is cut to this many characters in the breakdown


class Spans:
    """Spans of the benchmark's calls into the program's layers."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def wrap(self, name: str, fn):
        """``fn`` with each call recorded as a span ``name``."""
        def call(*args, **kw):
            with self(name):
                return fn(*args, **kw)
        return call


def start_device_trace():
    """A running ``torch.profiler`` over the card's activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation the card ran, once the
    profiler has stopped."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def _attribute(idle: dict, spans: list[tuple[str, int, int]], starts: list[int], g0: int, g1: int) -> None:
    """Add the idle interval [g0, g1) to ``idle`` by the spans it overlaps
    (the benchmark's spans do not overlap), the rest to ``"outside spans"``."""
    left = g1 - g0
    i = bisect.bisect_left(starts, g1) - 1
    while i >= 0 and spans[i][2] > g0:
        name, t0, t1 = spans[i]
        part = min(t1, g1) - max(t0, g0)
        if part > 0:
            idle[name] = idle.get(name, 0) + part
            left -= part
        i -= 1
    if left > 0:
        idle["outside spans"] = idle.get("outside spans", 0) + left


def reduce_trace(events: list[tuple[str, int, int]], window: tuple[int, int],
                 spans: list[tuple[str, int, int]]) -> dict:
    """Busy seconds (the union of the device's operations inside the window),
    the window's seconds, seconds and count by operation name, the operations
    that took most time, and idle seconds by the span that covered them."""
    w0, w1 = window
    clipped = sorted((max(a, w0), min(b, w1), name) for name, a, b in events if b > w0 and a < w1)
    by_name: dict[str, list] = {}
    busy = 0
    idle: dict[str, int] = {}
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    cursor = w0
    for a, b, name in clipped:
        tot = by_name.setdefault(name, [0, 0])
        tot[0] += b - a
        tot[1] += 1
        if a > cursor:
            _attribute(idle, spans, starts, cursor, a)
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        _attribute(idle, spans, starts, cursor, w1)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": {name: (ns / 1e9, n) for name, (ns, n) in by_name.items()},
        "device_ops": [[name[:NAME_CHARS], ns / 1e9] for name, (ns, _) in ops[:TOP]],
        "idle_gaps": [[name, ns / 1e9] for name, ns in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def kernel_time(trace: dict, *parts: str) -> tuple[float, int]:
    """Seconds and launches of the operations whose names hold any of ``parts``."""
    secs, n = 0.0, 0
    for name, (s, c) in trace["kernels"].items():
        if any(p in name for p in parts):
            secs += s
            n += c
    return secs, n
