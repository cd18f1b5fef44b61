"""Span-based tracing for the FDB composition tree.

One operation through a composed tree — ``select -> codec -> async lane ->
wire -> server -> backend`` — shows up in :class:`~repro.metrics.IOStats`
only as totals.  The tracer answers the complementary question: *where did
this particular retrieve spend its 40 ms*.

Design points, in the order they matter:

- **Zero cost when disabled.**  Every ``FDBClient`` carries a class-level
  ``_trace = NULL_TRACER``.  The null tracer returns one process-wide
  singleton span whose methods are no-ops, so the instrumented hot paths
  (``with tr.span("fdb.archive") as sp``) allocate nothing inside this
  module.  Call sites guard attribute computation with ``if tr.enabled``.
- **Explicit parents, two kinds of edges.**  A span records ``parent_id``
  (strict containment: the child ran inside the parent's interval on some
  thread) and optionally ``link_id`` (follows-from: the AsyncFDB writer
  lane executes *after* the enqueue span has closed, so containment cannot
  hold — the execution span instead *links* to the enqueue span while
  sharing its trace id).
- **Pluggable clock.**  ``Tracer(clock=...)`` defaults to
  ``time.perf_counter``; the contention sweep passes the model's virtual
  clock so discrete-event traces read identically to wall-time ones.
- **Ring buffer.**  Finished spans land in a bounded deque under a lock;
  ``drain()`` hands them over for export or the wire TRACE round.
- **Slow-op watchdog.**  When a *root* span finishes over
  ``slow_op_s``, the full span tree for its trace is captured from the
  ring into a small ``slow_ops`` deque before eviction can lose it.

Span/trace ids are 64-bit: a pid-derived salt in the high bits plus a
process-global counter, so ids from a client and an in-process (or
spawned) server never collide when stitched into one trace.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "install_tracer",
    "make_tracer",
]

_IDS = itertools.count(1)

_IMPLICIT = object()  # sentinel: "parent from the current thread's stack"


def _id_salt() -> int:
    # High 14 bits from the pid: ids minted by a spawned server process
    # stay distinct from the client's when stitched into one trace.
    return (os.getpid() & 0x3FFF) << 48


def _new_id() -> int:
    return _id_salt() | next(_IDS)


class SpanContext:
    """The propagatable part of a span: ``(trace_id, span_id)``.

    Cheap enough to ride in AsyncFDB queue items and small enough for a
    16-byte wire prefix on traced protocol frames.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SpanContext(trace_id={self.trace_id:#x}, span_id={self.span_id:#x})"


class Span:
    """A timed interval with explicit parentage.  Use as a context manager."""

    __slots__ = (
        "tracer",
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "link_id",
        "t0",
        "t1",
        "attrs",
        "thread_id",
        "proc",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: int,
        span_id: int,
        parent_id: int | None,
        link_id: int | None,
        t0: float,
        proc: str,
    ) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.link_id = link_id
        self.t0 = t0
        self.t1: float | None = None
        self.attrs: dict[str, Any] | None = None
        self.thread_id = threading.get_ident()
        self.proc = proc

    # -- recording ---------------------------------------------------------

    def set(self, key: str, value: Any) -> None:
        """Attach an attribute.  The attrs dict is created lazily."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else self.tracer.clock()
        return end - self.t0

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.set("error", exc_type.__name__)
        self.tracer._pop(self)
        return False

    # -- serialisation -----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "t0": self.t0,
            "t1": self.t1,
            "thread": self.thread_id,
            "proc": self.proc,
        }
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        if self.link_id is not None:
            d["link_id"] = self.link_id
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Span({self.name!r}, trace={self.trace_id:#x}, dur={self.duration_s:.6f}s)"


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    Parameters
    ----------
    clock:
        Zero-arg callable returning a monotonically non-decreasing float
        (seconds).  Defaults to ``time.perf_counter``; pass the contention
        model's virtual clock to trace discrete-event runs.
    capacity:
        Ring-buffer size; the oldest finished spans are evicted first.
    slow_op_s:
        If set, any *root* span finishing with a duration at or over this
        threshold captures its full span tree into :attr:`slow_ops`.
    slow_capacity:
        How many slow-op trees to keep.
    proc:
        Process label stamped on every span (``"client"``, ``"server"``,
        a sweep cell name, ...); becomes the Chrome trace process track.
    """

    enabled = True

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.perf_counter,
        capacity: int = 65536,
        slow_op_s: float | None = None,
        slow_capacity: int = 32,
        proc: str = "client",
    ) -> None:
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.clock = clock
        self.proc = proc
        self.slow_op_s = slow_op_s
        self._ring: deque[Span] = deque(maxlen=int(capacity))
        self.slow_ops: deque[dict[str, Any]] = deque(maxlen=int(slow_capacity))
        self._mu = threading.Lock()
        self._tls = threading.local()

    # -- span creation -----------------------------------------------------

    def span(
        self,
        name: str,
        parent: Any = _IMPLICIT,
        link: SpanContext | None = None,
        remote_parent: SpanContext | None = None,
    ) -> Span:
        """Start a span.

        ``parent`` defaults to the innermost open span on the *current
        thread*; pass ``None`` to force a new root, or an explicit
        :class:`Span`/:class:`SpanContext` (e.g. handed across a thread
        pool) to parent across threads.  ``link`` records a follows-from
        edge (shares the trace id, no containment claim).
        ``remote_parent`` parents under a context received off the wire.
        """
        if remote_parent is not None:
            trace_id = remote_parent.trace_id
            parent_id: int | None = remote_parent.span_id
            link_id = None
        elif link is not None:
            trace_id = link.trace_id
            parent_id = None
            link_id = link.span_id
        else:
            if parent is _IMPLICIT:
                parent = self._current()
            if parent is None:
                trace_id = _new_id()
                parent_id = None
            else:
                trace_id = parent.trace_id
                parent_id = parent.span_id
            link_id = None
        return Span(self, name, trace_id, _new_id(), parent_id, link_id, self.clock(), self.proc)

    def current(self) -> SpanContext | None:
        """Context of the innermost open span on this thread, if any."""
        sp = self._current()
        return None if sp is None else sp.context

    def _current(self) -> Span | None:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        stack.append(span)

    def _pop(self, span: Span) -> None:
        span.t1 = self.clock()
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:  # pragma: no cover - misnested exit
            stack.remove(span)
        self._finish(span)

    def _finish(self, span: Span) -> None:
        with self._mu:
            self._ring.append(span)
        if (
            self.slow_op_s is not None
            and span.parent_id is None
            and span.proc == self.proc
            and span.duration_s >= self.slow_op_s
        ):
            self._capture_slow(span)

    def _capture_slow(self, root: Span) -> None:
        tree = [s.to_dict() for s in self.spans() if s.trace_id == root.trace_id]
        self.slow_ops.append(
            {
                "trace_id": root.trace_id,
                "root": root.name,
                "duration_s": root.duration_s,
                "spans": tree,
            }
        )

    # -- collection --------------------------------------------------------

    def spans(self) -> list[Span]:
        """Snapshot of finished spans, oldest first (ring not cleared)."""
        with self._mu:
            return list(self._ring)

    def drain(self) -> list[Span]:
        """Remove and return all finished spans (the wire TRACE round)."""
        with self._mu:
            out = list(self._ring)
            self._ring.clear()
        return out

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
        self.slow_ops.clear()

    def adopt(self, records: Iterable[Mapping[str, Any]], proc: str | None = None) -> int:
        """Import finished spans exported by another tracer (e.g. spans a
        server returned over the TRACE round), preserving their ids and
        timestamps so they stitch into the local trace.  Returns the count.
        """
        n = 0
        with self._mu:
            for rec in records:
                sp = Span(
                    self,
                    str(rec["name"]),
                    int(rec["trace_id"]),
                    int(rec["span_id"]),
                    rec.get("parent_id"),
                    rec.get("link_id"),
                    float(rec["t0"]),
                    proc or str(rec.get("proc", "remote")),
                )
                sp.t1 = float(rec["t1"]) if rec.get("t1") is not None else sp.t0
                sp.thread_id = int(rec.get("thread", 0))
                attrs = rec.get("attrs")
                if attrs:
                    sp.attrs = dict(attrs)
                self._ring.append(sp)
                n += 1
        return n


class _NullSpan:
    """Singleton no-op span: the entire disabled-tracing hot path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass

    @property
    def context(self) -> None:
        return None

    name = "null"
    trace_id = 0
    span_id = 0


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call returns the singleton null span."""

    enabled = False
    proc = "client"
    slow_op_s = None

    def span(self, name, parent=_IMPLICIT, link=None, remote_parent=None) -> _NullSpan:
        return _NULL_SPAN

    def current(self) -> None:
        return None

    def spans(self) -> list:
        return []

    def drain(self) -> list:
        return []

    def clear(self) -> None:
        pass

    def adopt(self, records, proc=None) -> int:
        return 0

    @property
    def slow_ops(self) -> list:
        return []


NULL_TRACER = NullTracer()


def install_tracer(client: Any, tracer: Any) -> int:
    """Install ``tracer`` on ``client`` and every facade below it.

    Walks the composition tree through the well-known child attributes
    (``inner``, ``fdb``, ``tiers``, ``lanes``) so one call covers a whole
    ``build_fdb`` tree.  Returns the number of clients touched.
    """
    stack = [client]
    seen: set[int] = set()
    n = 0
    while stack:
        c = stack.pop()
        if id(c) in seen or not hasattr(c, "_trace"):
            continue
        seen.add(id(c))
        c._trace = tracer
        n += 1
        for attr in ("inner", "fdb"):
            sub = getattr(c, attr, None)
            if sub is not None and hasattr(sub, "_trace"):
                stack.append(sub)
        for attr in ("tiers", "lanes"):
            subs = getattr(c, attr, None)
            if subs:
                stack.extend(s for s in subs if hasattr(s, "_trace"))
    return n


def make_tracer(spec: Any, *, proc: str = "client") -> Tracer:
    """Build a :class:`Tracer` from a config value.

    ``True`` gives defaults; a mapping accepts ``capacity``, ``slow_op_s``
    and ``slow_capacity`` (this is the ``"trace"`` option in ``FDBConfig``).
    """
    if spec is True:
        return Tracer(proc=proc)
    if isinstance(spec, Mapping):
        kwargs: dict[str, Any] = {"proc": str(spec.get("proc", proc))}
        if "capacity" in spec:
            kwargs["capacity"] = int(spec["capacity"])
        if "slow_op_s" in spec:
            kwargs["slow_op_s"] = float(spec["slow_op_s"])
        if "slow_capacity" in spec:
            kwargs["slow_capacity"] = int(spec["slow_capacity"])
        return Tracer(**kwargs)
    raise TypeError(f"trace spec must be True or a mapping, got {type(spec).__name__}")
