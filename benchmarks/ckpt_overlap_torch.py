"""Async-checkpoint overlap benchmark.

The paper's operational point: producers must keep producing while storage
absorbs data (70% of fields consumed mid-run).  Here: a training loop whose
checkpoint writes go through an FDB with injected per-op storage latency —
blocking saves stall the step loop; the async manager hides the latency
behind compute (straggler isolation).
"""

from __future__ import annotations

import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import CHECKPOINT_SCHEMA, FDB, make_fdb
from repro_torch.core.daos import DaosEngine

__all__ = ["run_overlap_benchmark"]


class _SlowFDB:
    """Proxy adding fixed latency per archive/flush (a busy storage node)."""

    def __init__(self, inner: FDB, archive_s: float = 0.002, flush_s: float = 0.05):
        self._inner = inner
        self._archive_s = archive_s
        self._flush_s = flush_s

    def archive(self, key, data):
        time.sleep(self._archive_s)
        return self._inner.archive(key, data)

    def flush(self):
        time.sleep(self._flush_s)
        return self._inner.flush()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def run_overlap_benchmark(n_steps: int = 12, ckpt_every: int = 3, step_s: float = 0.03) -> dict:
    import numpy as np

    state = {"w": np.random.default_rng(0).standard_normal((128, 128)).astype(np.float32)}

    def run(async_mode: bool) -> float:
        fdb = _SlowFDB(make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=DaosEngine()))
        mgr = CheckpointManager(fdb, "overlap", async_mode=async_mode)
        t0 = time.perf_counter()
        for step in range(1, n_steps + 1):
            time.sleep(step_s)  # the compute step
            if step % ckpt_every == 0:
                mgr.save(step, state, blocking=not async_mode)
        mgr.wait()
        return time.perf_counter() - t0

    blocking = run(async_mode=False)
    async_ = run(async_mode=True)
    compute_floor = n_steps * step_s
    return {
        "blocking_s": blocking,
        "async_s": async_,
        "compute_floor_s": compute_floor,
        "io_hidden_frac": max(0.0, min(1.0, (blocking - async_) / max(blocking - compute_floor, 1e-9))),
    }
