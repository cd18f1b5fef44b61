"""Trace export: Chrome trace-event JSON (Perfetto-loadable) and JSONL.

The Chrome trace-event format is the JSON object form::

    {"traceEvents": [{"name": ..., "ph": "X", "ts": µs, "dur": µs,
                      "pid": int, "tid": int, "args": {...}}, ...]}

Complete spans map to ``"X"`` duration events.  Follows-from links
(AsyncFDB enqueue -> writer-lane execution) map to flow event pairs
(``"s"`` at the source span's end, ``"f"`` at the destination's start) so
Perfetto draws the queue-wait arrow.  ``"M"`` metadata events name the
process (tracer ``proc`` label: client vs server vs sweep cell) and
thread tracks.

``validate_chrome_trace`` is the schema check CI runs against the hammer
artifact — intentionally strict about the fields Perfetto needs.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Mapping

from .tracer import Span

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "validate_chrome_trace",
]

_PHASES = {"X", "M", "s", "f"}


def _span_dicts(spans: Iterable[Any]) -> list[dict[str, Any]]:
    out = []
    for s in spans:
        out.append(s.to_dict() if isinstance(s, Span) else dict(s))
    return out


def chrome_trace(spans: Iterable[Any]) -> dict[str, Any]:
    """Render finished spans (``Span`` objects or their dicts) to a Chrome
    trace-event JSON object."""
    recs = _span_dicts(spans)
    by_id = {r["span_id"]: r for r in recs}

    pids: dict[str, int] = {}
    tids: dict[tuple[str, int], int] = {}
    events: list[dict[str, Any]] = []

    def pid_of(proc: str) -> int:
        if proc not in pids:
            pids[proc] = len(pids) + 1
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "ts": 0,
                    "pid": pids[proc],
                    "tid": 0,
                    "args": {"name": proc},
                }
            )
        return pids[proc]

    def tid_of(proc: str, thread: int) -> int:
        key = (proc, thread)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == proc]) + 1
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "ts": 0,
                    "pid": pid_of(proc),
                    "tid": tids[key],
                    "args": {"name": f"thread-{thread:#x}"},
                }
            )
        return tids[key]

    for r in recs:
        proc = str(r.get("proc", "client"))
        pid = pid_of(proc)
        tid = tid_of(proc, int(r.get("thread", 0)))
        t0 = float(r["t0"])
        t1 = float(r["t1"]) if r.get("t1") is not None else t0
        args: dict[str, Any] = {
            "trace_id": f"{r['trace_id']:#x}",
            "span_id": f"{r['span_id']:#x}",
        }
        if r.get("parent_id") is not None:
            args["parent_id"] = f"{r['parent_id']:#x}"
        if r.get("attrs"):
            args.update(r["attrs"])
        events.append(
            {
                "name": str(r["name"]),
                "cat": "fdb",
                "ph": "X",
                "ts": t0 * 1e6,
                "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
        link = r.get("link_id")
        if link is not None:
            src = by_id.get(link)
            if src is not None:
                s_proc = str(src.get("proc", "client"))
                s_t1 = float(src["t1"]) if src.get("t1") is not None else float(src["t0"])
                events.append(
                    {
                        "name": "follows",
                        "cat": "flow",
                        "ph": "s",
                        "id": int(link),
                        "ts": s_t1 * 1e6,
                        "pid": pid_of(s_proc),
                        "tid": tid_of(s_proc, int(src.get("thread", 0))),
                    }
                )
                events.append(
                    {
                        "name": "follows",
                        "cat": "flow",
                        "ph": "f",
                        "bp": "e",
                        "id": int(link),
                        "ts": t0 * 1e6,
                        "pid": pid,
                        "tid": tid,
                    }
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Any]) -> int:
    """Write a Chrome trace-event JSON file; returns the event count."""
    doc = chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
    return len(doc["traceEvents"])


def write_jsonl(path: str, spans: Iterable[Any]) -> int:
    """Write one JSON object per finished span; returns the span count."""
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for r in _span_dicts(spans):
            f.write(json.dumps(r, separators=(",", ":")))
            f.write("\n")
            n += 1
    return n


def validate_chrome_trace(doc: Any) -> int:
    """Validate a Chrome trace-event JSON object; returns the event count.

    Raises ``ValueError`` naming the first malformed event.  Used by the
    CI trace smoke and the export tests.
    """
    if not isinstance(doc, Mapping):
        raise ValueError("trace document must be a JSON object")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace document must carry a 'traceEvents' list")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, Mapping):
            raise ValueError(f"{where}: event must be an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"{where}: unsupported phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{where}: missing event name")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                raise ValueError(f"{where}: {field} must be an int")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"{where}: ts must be a non-negative number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: X event needs a non-negative dur")
        if ph in ("s", "f") and not isinstance(ev.get("id"), int):
            raise ValueError(f"{where}: flow event needs an int id")
    return len(events)
