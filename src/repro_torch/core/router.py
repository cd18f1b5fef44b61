"""FDBRouter — multi-lane sharding across independent (Catalogue, Store) pairs.

One FDB instance funnels every archive through a single Catalogue/Store
pair; at scale that single lane becomes the bottleneck (one TOC per dataset
on POSIX, one index-KV per collocation on DAOS).  The router shards *dataset
keys* across N fully independent lanes:

- each lane is any :class:`~repro.core.client.FDBClient` (a plain
  :class:`~repro.core.fdb.FDB`, an
  :class:`~repro.core.async_fdb.AsyncFDB`, even another router) — lanes
  may use DIFFERENT backends (e.g. hot datasets on DAOS, cold on POSIX);
- placement is a stable hash of the stringified dataset key, so every field
  of a dataset lives in exactly one lane and lookups need no broadcast;
- ``flush()`` flushes each lane (each lane internally orders store before
  catalogue, so the §1.3 invariant holds per lane — there is no cross-lane
  ordering requirement because datasets are disjoint);
- ``list()`` merges the per-lane listings (disjoint by construction, so the
  merge is a plain concatenation, no dedup pass).

All lanes must share one schema: the split and the hash must agree.  The
shared client surface (reads, MARS-style retrieval, wipe reports) comes
from :class:`FDBClient` — this class adds only the routing.
"""

from __future__ import annotations

import zlib
from typing import Iterator, Mapping, Sequence

from .catalogue import ListEntry
from .client import FDBClient, WipeReport
from .datahandle import DataHandle
from .keys import Key
from .request import Request
from .schema import Schema

__all__ = ["FDBRouter", "make_router"]


class FDBRouter(FDBClient):
    def __init__(self, lanes: Sequence, *, shared: Sequence[FDBClient] = ()):
        """``shared``: lanes this router does NOT own — flush/drain still
        reach them, ``close()`` leaves them open (config builds list
        prebuilt pass-through subtrees here)."""
        lanes = list(lanes)
        if not lanes:
            raise ValueError("router needs at least one lane")
        self.lanes = lanes
        self._shared = {id(lane) for lane in shared}
        self.schema: Schema = lanes[0].schema
        for lane in lanes[1:]:
            if lane.schema != self.schema:
                raise ValueError(
                    f"all lanes must share one schema: {lane.schema.name!r} != {self.schema.name!r}"
                )

    # ------------------------------------------------------------------ routing
    def lane_index(self, key: Key | Mapping[str, str]) -> int:
        """Stable hash of the stringified dataset sub-key -> lane."""
        ds = self._as_key(key).subset(self.schema.dataset_keys)
        return zlib.crc32(ds.stringify().encode()) % len(self.lanes)

    def _lane(self, key: Key | Mapping[str, str]):
        return self.lanes[self.lane_index(key)]

    def _scatter(self, keys: Sequence[Key | Mapping[str, str]], method: str) -> list:
        """Group *keys* by lane, call the lane's batch *method* per group,
        reassemble results in input order."""
        tr = self._trace
        with tr.span("router.scatter") as sp:
            groups: dict[int, list[int]] = {}
            for i, key in enumerate(keys):
                groups.setdefault(self.lane_index(key), []).append(i)
            if tr.enabled:
                sp.set("method", method)
                sp.set("n_keys", len(keys))
                sp.set("n_lanes", len(groups))
            out: list = [None] * len(keys)
            for lane_i, idxs in groups.items():
                with tr.span("router.lane") as lsp:
                    if tr.enabled:
                        lsp.set("lane", lane_i)
                        lsp.set("n_keys", len(idxs))
                    results = getattr(self.lanes[lane_i], method)(
                        [keys[i] for i in idxs]
                    )
                for i, r in zip(idxs, results):
                    out[i] = r
            return out

    # ---------------------------------------------------------------------- API
    def archive(self, key: Key | Mapping[str, str], data: bytes) -> None:
        self._lane(key).archive(key, data)

    def archive_batch(self, items: Sequence[tuple[Key | Mapping[str, str], bytes]]) -> None:
        tr = self._trace
        with tr.span("router.archive_batch") as sp:
            groups: dict[int, list[tuple[Key | Mapping[str, str], bytes]]] = {}
            for key, data in items:
                groups.setdefault(self.lane_index(key), []).append((key, data))
            if tr.enabled:
                sp.set("n_items", len(items))
                sp.set("n_lanes", len(groups))
            for lane_i, group in groups.items():
                with tr.span("router.lane_archive") as lsp:
                    if tr.enabled:
                        lsp.set("lane", lane_i)
                        lsp.set("n_items", len(group))
                    self.lanes[lane_i].archive_batch(group)

    def archive_fields(self, keys, fields, *, nbits=None) -> None:
        """Shard the batch BEFORE packing: each lane packs its own slice
        (lanes may be codec tiers with distinct widths), and every lane
        still sees one whole-batch kernel launch for its share."""
        from .codec import take_fields

        tr = self._trace
        with tr.span("router.archive_fields") as sp:
            keys = list(keys)
            groups: dict[int, list[int]] = {}
            for i, key in enumerate(keys):
                groups.setdefault(self.lane_index(key), []).append(i)
            if tr.enabled:
                sp.set("n_fields", len(keys))
                sp.set("n_lanes", len(groups))
            for lane_i, idxs in groups.items():
                with tr.span("router.lane_archive_fields") as lsp:
                    if tr.enabled:
                        lsp.set("lane", lane_i)
                        lsp.set("n_fields", len(idxs))
                    self.lanes[lane_i].archive_fields(
                        [keys[i] for i in idxs], take_fields(fields, idxs), nbits=nbits
                    )

    def flush(self) -> None:
        for lane in self.lanes:
            lane.flush()

    def drain(self) -> None:
        # a router over AsyncFDB lanes must forward the write barrier — the
        # base no-op would silently skip it and a caller's commit ordering
        # (drain, then sentinel) would break
        for lane in self.lanes:
            lane.drain()

    def retrieve(self, key: Key | Mapping[str, str]) -> DataHandle | None:
        return self._lane(key).retrieve(key)

    def retrieve_batch(self, keys: Sequence[Key | Mapping[str, str]]) -> list[DataHandle | None]:
        return self._scatter(keys, "retrieve_batch")

    def read(self, key: Key | Mapping[str, str]) -> bytes | None:
        return self._lane(key).read(key)

    def read_batch(self, keys: Sequence[Key | Mapping[str, str]]) -> list[bytes | None]:
        return self._scatter(keys, "read_batch")

    def _list(self, request: Request) -> Iterator[ListEntry]:
        """Merged listing: lanes hold disjoint datasets, so concatenating
        the per-lane iterators IS the merge.  The request is already
        validated — go straight to the lanes' backend listing."""
        for lane in self.lanes:
            yield from getattr(lane, "_list", lane.list)(request)

    def _wipe_dataset(self, dataset_key: Key, entries=None) -> WipeReport:
        return self._lane(dataset_key)._wipe_dataset(dataset_key, entries)

    # ------------------------------------------------------------- telemetry
    def io_stats(self) -> list:
        """Distinct stats instances across all lanes (lanes built by
        :func:`make_router` carry per-lane sinks; shared sinks — e.g. one
        DAOS engine behind every lane — are deduplicated)."""
        seen: dict[int, object] = {}
        for lane in self.lanes:
            getter = getattr(lane, "io_stats", None)
            if getter is None:
                continue
            for s in getter():
                seen.setdefault(id(s), s)
        return list(seen.values()) + self._codec_sinks()

    def stats_snapshot(self) -> dict:
        """Merged telemetry plus the per-lane breakdown."""
        snap = super().stats_snapshot()
        snap["lanes"] = [
            lane.stats_snapshot() if hasattr(lane, "stats_snapshot") else {}
            for lane in self.lanes
        ]
        return snap

    def close(self) -> None:
        # a failing lane must not leave the healthy ones unflushed: close
        # every owned lane (shared ones only flush — the caller closes
        # them), then re-raise the first failure
        first_err: Exception | None = None
        for lane in self.lanes:
            try:
                if id(lane) in self._shared:
                    lane.flush()
                else:
                    lane.close()
            except Exception as e:  # noqa: BLE001
                first_err = first_err or e
        if first_err is not None:
            raise first_err


def make_router(
    backend: str,
    n_lanes: int,
    *,
    schema: Schema,
    root: str | None = None,
    engine=None,
    pool: str = "fdb",
    contention=None,
    **kw,
) -> FDBRouter:
    """Build an N-lane router of homogeneous backends — a thin shim that
    assembles a ``{"type": "dist", "lanes": [...]}`` config and hands it to
    :func:`repro.core.config.build_fdb` (use that directly for heterogeneous
    lane mixes or nested compositions).

    posix: lane *i* lives under ``root/lane{i}`` (independent TOCs/streams)
    and gets its OWN :class:`PosixStats` sink, so ``stats_snapshot()`` can
    break traffic down per lane.
    daos: lane *i* uses pool ``{pool}-lane{i}`` on a shared engine
    (independent root containers and index KVs; telemetry is per-engine).
    A ``contention`` model is shared by every lane — the lanes contend for
    the same emulated servers.
    """
    from .config import build_fdb

    if n_lanes < 1:
        raise ValueError("need at least one lane")
    shared_stats = kw.pop("stats", None)  # explicit sink: shared by all lanes
    if shared_stats is not None and backend == "daos":
        raise ValueError("daos router does not take stats= (engine.stats is the telemetry sink)")
    lanes: list[dict] = []
    for i in range(n_lanes):
        if backend == "posix":
            if root is None:
                raise ValueError("posix router requires root=")
            import os

            from .posix import PosixStats

            lane = {
                "backend": "posix", "schema": schema,
                "root": os.path.join(root, f"lane{i}"),
                "stats": shared_stats or PosixStats(name=f"posix-lane{i}"),
                **kw,
            }
            if contention is not None:
                lane["contention"] = contention
            lanes.append(lane)
        elif backend == "daos":
            if engine is None:
                from .daos import DaosEngine

                engine = DaosEngine(contention=contention)
            lanes.append(
                {"backend": "daos", "schema": schema, "engine": engine,
                 "pool": f"{pool}-lane{i}", **kw}
            )
        else:
            raise ValueError(f"unknown router backend {backend!r}")
    router = build_fdb({"type": "dist", "lanes": lanes})
    assert isinstance(router, FDBRouter)
    return router
