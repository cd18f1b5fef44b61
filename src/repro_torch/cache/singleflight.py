"""Single-flight request coalescing (the dissemination fan-out primitive).

Forecast dissemination is write-once read-many-millions: when a product
lands, thousands of clients ask for the SAME field within the same second
(arXiv 2404.03107 §1; the interface follow-up 2311.18714 frames the
read-side API question).  A plain cache does not help with that stampede —
every concurrent miss of one key still pays a backend round.  Single-flight
collapses them: the first requester of a key becomes the *leader* and pays
the backend round; everyone else arriving while that round is in flight
becomes a *follower* and blocks on the leader's future.  N concurrent
identical requests cost exactly one backend call.

Error semantics (the part naive implementations get wrong): the in-flight
entry is removed BEFORE the leader's outcome is published, so a failed
flight is never a cached exception — followers of the failed flight observe
the leader's error once, and the next requester starts a fresh flight.
"""

from __future__ import annotations

import threading
from typing import Any, Hashable

__all__ = ["Flight", "SingleFlight"]


class Flight:
    """One in-flight backend round: the leader's future its followers wait
    on.  ``value``/``error`` are published exactly once, by ``complete``."""

    __slots__ = ("_done", "value", "error")

    def __init__(self) -> None:
        self._done = threading.Event()
        self.value: Any = None
        self.error: BaseException | None = None

    @property
    def done(self) -> bool:
        return self._done.is_set()


class SingleFlight:
    """A group of keyed flights.  ``join`` elects exactly one leader per key
    per flight; ``complete`` publishes the outcome and retires the flight."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._inflight: dict[Hashable, Flight] = {}

    def join(self, key: Hashable) -> tuple[Flight, bool]:
        """Return ``(flight, is_leader)``: the caller either owns a fresh
        flight (and MUST eventually ``complete`` it, on error paths too) or
        follows an existing one (``wait`` for the outcome)."""
        with self._mu:
            f = self._inflight.get(key)
            if f is not None:
                return f, False
            f = Flight()
            self._inflight[key] = f
            return f, True

    def complete(
        self,
        key: Hashable,
        flight: Flight,
        value: Any = None,
        error: BaseException | None = None,
    ) -> None:
        """Publish the leader's outcome.  The in-flight entry is dropped
        FIRST: late requesters after a failure start a new flight instead of
        observing a stale exception (errors are never cached)."""
        with self._mu:
            if self._inflight.get(key) is flight:
                del self._inflight[key]
        flight.value = value
        flight.error = error
        flight._done.set()

    def wait(self, flight: Flight, timeout: float | None = None) -> Any:
        """Block for the leader's outcome; re-raises the leader's error."""
        if not flight._done.wait(timeout):
            raise TimeoutError(f"single-flight leader did not complete in {timeout}s")
        if flight.error is not None:
            raise flight.error
        return flight.value

    def inflight(self) -> int:
        """Number of currently open flights (telemetry / tests)."""
        with self._mu:
            return len(self._inflight)
