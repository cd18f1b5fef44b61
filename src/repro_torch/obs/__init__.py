"""repro.obs — distributed tracing for the FDB composition tree.

- :class:`Tracer` / :class:`Span` / :class:`SpanContext` — span recording
  with explicit parent and follows-from links, a bounded ring buffer, a
  pluggable clock (wall or contention-model virtual time), and a slow-op
  watchdog.
- :data:`NULL_TRACER` — the disabled default installed on every
  ``FDBClient``; zero allocations on the instrumented hot paths.
- :func:`install_tracer` — thread one tracer through a whole ``build_fdb``
  tree (also reachable as the ``"trace"`` config option).
- :func:`chrome_trace` / :func:`write_chrome_trace` /
  :func:`write_jsonl` / :func:`validate_chrome_trace` — Perfetto-loadable
  Chrome trace-event JSON and a JSONL event log.
"""

from .export import (
    chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from .tracer import (
    NULL_TRACER,
    NullTracer,
    Span,
    SpanContext,
    Tracer,
    install_tracer,
    make_tracer,
)

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "install_tracer",
    "make_tracer",
    "chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "validate_chrome_trace",
]
