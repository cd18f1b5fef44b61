"""Deterministic sharded data pipeline with straggler mitigation.

Determinism-by-step: ``batch_for_step(step)`` is a pure function of
(seed, step, host shard), so a restart replays exactly — the data plane
needs no checkpoint beyond the step counter.

Straggler mitigation: a pool of reader threads pulls *work items* (shard
indices of the upcoming steps) from a shared deque — a slow reader never
blocks the step loop as long as any reader keeps up (work stealing), and
prefetch depth bounds memory.  This mirrors the paper's observation that
70% of produced data is consumed while the producers are still running:
the consumer side must be decoupled from individual producer latency.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticLM", "PrefetchPipeline"]


@dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic token stream (zipfian-ish)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_for_step(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index])
        )
        # zipf-flavored ids clipped to vocab, cheap + deterministic
        z = rng.zipf(1.3, size=(self.host_batch, self.seq_len + 1))
        toks = (z % (self.vocab - 2)).astype(np.int32) + 1
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class PrefetchPipeline:
    """Work-stealing prefetcher over any `batch_for_step` source."""

    def __init__(self, source, *, n_readers: int = 2, depth: int = 4,
                 delay_injector=None):
        self.source = source
        self.depth = depth
        self._work: queue.Queue[int] = queue.Queue()
        self._done: dict[int, dict] = {}
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._delay = delay_injector  # tests: fn(step) -> seconds, simulates stragglers
        self._next_to_schedule = 0
        self._readers = [
            threading.Thread(target=self._reader, name=f"reader-{i}", daemon=True)
            for i in range(n_readers)
        ]
        for _ in range(depth):
            self._work.put(self._next_to_schedule)
            self._next_to_schedule += 1
        for t in self._readers:
            t.start()

    def _reader(self) -> None:
        while not self._stop.is_set():
            try:
                step = self._work.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._delay:
                time.sleep(self._delay(step))
            batch = self.source.batch_for_step(step)
            with self._cv:
                self._done[step] = batch
                self._cv.notify_all()

    def get(self, step: int, timeout: float = 60.0) -> dict:
        """Blocks until `step`'s batch is ready (any reader may produce it)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while step not in self._done:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"batch for step {step} not produced in time")
                self._cv.wait(0.05)
            batch = self._done.pop(step)
        # keep the window full
        self._work.put(self._next_to_schedule)
        self._next_to_schedule += 1
        return batch

    def reset_to(self, step: int) -> None:
        """After restart: drop prefetched work and refill from `step`."""
        with self._cv:
            self._done.clear()
        while not self._work.empty():
            try:
                self._work.get_nowait()
            except queue.Empty:
                break
        self._next_to_schedule = step
        for _ in range(self.depth):
            self._work.put(self._next_to_schedule)
            self._next_to_schedule += 1

    def close(self) -> None:
        self._stop.set()
