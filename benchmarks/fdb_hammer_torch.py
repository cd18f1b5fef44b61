"""fdb-hammer port (paper §4.2): the FDB performance benchmark.

Drives the REAL backends (in-process DAOS engine / local POSIX) with N
concurrent "processes" (threads — the socket-served engine covers true OS
processes in tests).  Each process writes/reads an independent stream of
fields for a distinct ensemble member, mimicking the I/O-server and
post-processing patterns.  "I/O pessimised": all computation removed.

The same spec can be run through four I/O paths:

- ``io='sync'``     one synchronous round-trip per field (the seed path);
- ``io='batched'``  one ``archive_batch``/``read_batch`` per output step —
                    the backends amortise locks / OID allocation / event-
                    queue drains across the batch;
- ``io='async'``    each process drives an :class:`AsyncFDB` — a bounded
                    background writer pool keeps many fields in flight, and
                    retrieval fans a MARS-style request out in parallel;
- ``lanes=N``       shard datasets across an N-lane :class:`FDBRouter`
                    (set ``n_datasets > 1`` so there is something to shard).

Bandwidths use *global timing* (paper §4.3): total bytes / (last I/O end −
first I/O start).

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --procs 4

Declarative config mode (``--config``): build the FDB under test from a
JSON config tree (:func:`repro.core.config.build_fdb`) instead of the
hard-wired backends, and sweep it through the I/O modes — the paper's
tiered hot(DAOS)/cold(POSIX) deployment is the built-in ``tiered`` config:

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --config tiered --procs 4
    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --config my_fdb.json
    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --config '{"backend": "daos"}'

Local ``posix`` configs may omit ``root`` — the hammer fills in a scratch
directory per tier, so one JSON document runs anywhere.

Contended client-scaling sweep (paper Figs 3/4: per-client bandwidth under
rising client counts) — drives the real backends through the contention
model (:mod:`repro.metrics.contention`) on a deterministic virtual clock
and writes per-backend/per-``n_procs`` aggregate bandwidth + p50/p95/p99 op
latencies to ``BENCH_contention_torch.json``:

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --scaling --procs 32

GRIB codec mode (``--codec-nbits N``): archive float32 fields through
``archive_fields`` — the whole output-step batch bit-packs in ONE
``grib_pack`` CUDA launch before it touches the store — and retrieve
through ``retrieve_fields`` (lazy per-chunk unpack).  The sweeps then report
effective (pre-codec) next to wire bandwidth; ``--scaling`` adds a
``<backend>+codecN`` cell per backend to ``BENCH_contention_torch.json``:

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --scaling --codec-nbits 16
    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --config tiered-codec

Read-mostly dissemination mode (``--read-mult N``): forecast production is
write-once read-many — every archived field is retrieved N times.  With
``--cache`` the FDB under test is wrapped in the
:class:`~repro.cache.CacheFDB` dissemination tier (sharded read-through
cache + single-flight coalescing) and the sweeps report hit rate and bytes
served per backend byte; without it the same N× read load hits the backend
raw, so the two runs are the A/B cells.  ``--scaling --cache`` adds a
``"<backend>+cache"`` cell per backend to ``BENCH_contention_torch.json`` — cache
hits are charged at client-memory speed by the contention model, which is
what moves the read-side knee right:

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --read-mult 8 --cache
    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --scaling --read-mult 8 --cache

Churn-interference mode (``--churn``): the data-lifecycle experiment —
each cell builds a two-tier SelectFDB (hot tier takes every archive by
rule, cold is the default) with the :class:`~repro.lifecycle.LifecycleFDB`
migration engine above it, demoting every output step but the newest.
After the archive phase the foreground processes re-read everything while
the migrator runs as one more discrete-event participant on the SAME
contention model — migration traffic competes with foreground reads for
the modelled hardware, and the ``"<backend>+churn"`` cells merged into
``BENCH_contention_torch.json`` report foreground bandwidth with/without
migration, their ratio (the interference), fields migrated, and the
correctness audit (zero failed reads, zero duplicate listings):

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --churn --procs 8

Remote mode (``--remote``): the MEASURED counterpart of ``--scaling`` —
serve each backend behind an in-process asyncio
:class:`~repro.core.remote.FDBServer` and hammer it with REAL client
processes (``multiprocessing`` spawn, one :class:`RemoteFDB` per process,
one wire frame per output-step batch).  The measured cells land in
``BENCH_contention_torch.json`` as ``"<backend>+remote"`` entries (tagged
``"measured": true``) next to the simulated sweep, so the real knee can be
read against the virtual-clock one:

    PYTHONPATH=src python benchmarks/fdb_hammer_torch.py --remote --procs 4
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass, replace

import numpy as np

from repro_torch.core import (
    AsyncFDB,
    CodecFDB,
    Key,
    NWP_SCHEMA_DAOS,
    NWP_SCHEMA_POSIX,
    Request,
    SelectFDB,
    build_fdb,
    make_fdb,
    make_router,
    wire_size,
)
from repro_torch.cache import CacheFDB
from repro_torch.core.daos import DaosEngine
from repro_torch.core.posix import PosixStats
from repro_torch.lifecycle import LifecycleFDB
from repro_torch.metrics import make_contention

__all__ = [
    "HammerSpec",
    "run_hammer",
    "run_request",
    "make_backend",
    "make_churn_tree",
    "run_hammer_contended",
    "run_hammer_churn",
    "run_hammer_remote",
    "scaling_sweep",
    "churn_sweep",
    "remote_sweep",
    "TIERED_CONFIG",
    "TIERED_CODEC_CONFIG",
    "load_config",
    "run_config",
]

GiB = float(1 << 30)

IO_MODES = ("sync", "batched", "async")


@dataclass(frozen=True)
class HammerSpec:
    n_procs: int = 4
    n_steps: int = 5
    n_params: int = 5
    n_levels: int = 4
    field_size: int = 1 << 16
    io: str = "sync"       # 'sync' | 'batched' | 'async'
    n_datasets: int = 1    # distinct forecast runs (router lanes shard these)
    #: GRIB codec path: archive float32 fields through ``archive_fields``
    #: (one ``grib_pack`` launch per output-step batch) and retrieve through
    #: ``retrieve_fields``; None = raw opaque payloads (the seed path)
    codec_nbits: int | None = None
    #: read-mostly dissemination: each archived field is retrieved this many
    #: times in the retrieve phase (bandwidths count the bytes SERVED)
    read_mult: int = 1

    @property
    def fields_per_proc(self) -> int:
        return self.n_steps * self.n_params * self.n_levels

    @property
    def total_bytes(self) -> int:
        return self.n_procs * self.fields_per_proc * self.field_size

    @property
    def field_shape(self) -> tuple[int, int]:
        """(H, W) of the float32 grid carrying ``field_size`` raw bytes —
        codec mode archives arrays, not opaque byte strings.  W is pinned
        to 128 (the kernels' lane width)."""
        if self.field_size % 512:
            raise ValueError(
                f"codec mode needs field_size divisible by 512 "
                f"(float32 rows of 128), got {self.field_size}"
            )
        return (self.field_size // 512, 128)

    @property
    def total_wire_bytes(self) -> int:
        """Post-codec bytes on the wire (== ``total_bytes`` on raw runs,
        assuming a uniform ``codec_nbits`` width on codec runs)."""
        if self.codec_nbits is None:
            return self.total_bytes
        per_field = wire_size(self.field_shape, self.codec_nbits)
        return self.n_procs * self.fields_per_proc * per_field


def make_backend(
    backend: str,
    root: str | None = None,
    engine: DaosEngine | None = None,
    *,
    lanes: int = 1,
    stats=None,
    contention=None,
    codec_nbits: int | None = None,
    cache_bytes: int | None = None,
):
    """Build the FDB under test: a single-lane FDB, or an N-lane router;
    ``codec_nbits`` wraps it in a :class:`CodecFDB` tier of that width;
    ``cache_bytes`` wraps the result (outermost) in a
    :class:`~repro.cache.CacheFDB` dissemination tier of that budget, with
    hits charged to *contention* at client-memory speed."""
    if backend not in ("daos", "posix"):
        raise ValueError(f"unknown backend {backend!r}; pick 'daos' or 'posix'")
    schema = NWP_SCHEMA_DAOS if backend == "daos" else NWP_SCHEMA_POSIX
    if lanes > 1:
        if backend == "daos":
            fdb = make_router(
                "daos", lanes, schema=schema,
                engine=engine or DaosEngine(contention=contention), contention=contention,
            )
        else:
            fdb = make_router("posix", lanes, schema=schema, root=root, stats=stats,
                              contention=contention)
    elif backend == "daos":
        fdb = make_fdb("daos", schema=schema, engine=engine or DaosEngine(contention=contention))
    else:
        fdb = make_fdb("posix", schema=schema, root=root, stats=stats, contention=contention)
    if codec_nbits is not None:
        fdb = CodecFDB(fdb, nbits=codec_nbits, owns_inner=True)
    if cache_bytes is not None:
        fdb = CacheFDB(fdb, max_bytes=cache_bytes, contention=contention,
                       owns_inner=True)
    return fdb


def _trace_cell(fdb, label: str, sink: list | None, clock=None):
    """Install a fresh tracer (wall clock by default, a contention model's
    virtual clock in the scaling sweep) on one cell's FDB tree.  Returns a
    drain callback appending the finished spans — tagged with the cell
    label as their process — to *sink*; a no-op when tracing is off."""
    if sink is None:
        return lambda: None
    from repro_torch.obs import Tracer, install_tracer

    tr = Tracer(proc=label, clock=clock or time.perf_counter)
    install_tracer(fdb, tr)

    def drain() -> None:
        sink.extend(s.to_dict() for s in tr.drain())

    return drain


def _field_key(member: int, step: int, param: int, level: int, n_datasets: int = 1) -> Key:
    date = str(20240601 + member % max(1, n_datasets))
    return Key(
        {"class": "rd", "stream": "oper", "expver": "0001", "date": date, "time": "0000",
         "type": "ef", "levtype": "ml", "number": str(member), "levelist": str(level),
         "step": str(step), "param": str(130 + param)}
    )


def _step_keys(spec: HammerSpec, member: int, step: int) -> list[Key]:
    return [
        _field_key(member, step, param, level, spec.n_datasets)
        for param in range(spec.n_params)
        for level in range(spec.n_levels)
    ]


def _step_fields(spec: HammerSpec, member: int, step: int) -> np.ndarray:
    """One output step's worth of float32 fields (deterministic per
    member/step — temperature-like values, so the quantisation is honest)."""
    h, w = spec.field_shape
    rng = np.random.default_rng(1 + member * 10_007 + step)
    fields = rng.standard_normal((spec.n_params * spec.n_levels, h, w))
    return (fields * 40.0 + 250.0).astype(np.float32)


def _step_request(spec: HammerSpec, member: int, step: int) -> dict:
    """The MARS request covering exactly one member/step batch."""
    base = dict(_field_key(member, step, 0, 0, spec.n_datasets))
    base["param"] = [str(130 + p) for p in range(spec.n_params)]
    base["levelist"] = [str(lv) for lv in range(spec.n_levels)]
    return base


def run_hammer(fdb, spec: HammerSpec, mode: str) -> dict:
    """mode: 'archive' | 'retrieve' | 'list'.  Returns timings + bandwidth."""
    if spec.io not in IO_MODES:
        raise ValueError(f"unknown io mode {spec.io!r}; pick one of {IO_MODES}")
    payload = np.random.default_rng(0).bytes(spec.field_size)
    starts = [0.0] * spec.n_procs
    ends = [0.0] * spec.n_procs
    errors: list[Exception] = []

    def proc(member: int) -> None:
        handle = fdb
        if spec.io == "async" and spec.codec_nbits is None:
            # one async facade per "process", as the I/O servers would hold.
            # codec mode skips the wrapper: archive_fields is already whole-
            # batch amortised, and packing ABOVE the tree would bypass
            # per-tier codec widths and strand the per-proc telemetry sink
            # (compose codec OVER async when both are wanted)
            handle = AsyncFDB(fdb, writers=2, batch_size=16)
        try:
            t0 = time.perf_counter()
            if mode == "archive":
                for step in range(spec.n_steps):
                    if spec.codec_nbits is not None:
                        # codec path: the whole step batch bit-packs in ONE
                        # grib_pack launch, then lands via archive_batch
                        # (nbits stays None — the facade's tier width rules)
                        handle.archive_fields(
                            _step_keys(spec, member, step), _step_fields(spec, member, step)
                        )
                    elif spec.io == "batched":
                        handle.archive_batch([(k, payload) for k in _step_keys(spec, member, step)])
                    else:  # sync round-trips, or async enqueues to the pool
                        for k in _step_keys(spec, member, step):
                            handle.archive(k, payload)
                    handle.flush()  # once per output step, as the I/O servers do
            elif mode == "retrieve":
                # read-mostly dissemination: every field is served read_mult
                # times (the first round fills a cache tier when one rides
                # above the backend; the rest are its hits)
                reps = [
                    (rep, step)
                    for rep in range(max(1, spec.read_mult))
                    for step in range(spec.n_steps)
                ]
                for _rep, step in reps:
                    if spec.codec_nbits is not None:
                        arrs = handle.retrieve_fields(_step_request(spec, member, step)).arrays()
                        assert arrs.shape == (
                            spec.n_params * spec.n_levels, *spec.field_shape,
                        )
                    elif spec.io == "sync":
                        for k in _step_keys(spec, member, step):
                            data = handle.read(k)
                            assert data is not None and len(data) == spec.field_size
                    elif spec.io == "batched":
                        datas = handle.read_batch(_step_keys(spec, member, step))
                        assert all(d is not None and len(d) == spec.field_size for d in datas)
                    else:  # async: MARS-style request, parallel batched reads
                        datas = handle.retrieve_many(_step_request(spec, member, step)).read_all()
                        assert len(datas) == spec.n_params * spec.n_levels
                        assert all(d is not None and len(d) == spec.field_size for d in datas.values())
            elif mode == "list":
                # post-processing pattern: list everything for one step
                n = sum(1 for _ in handle.list({"step": "0"}))
                assert n >= spec.n_params * spec.n_levels
            else:
                raise ValueError(mode)
            starts[member], ends[member] = t0, time.perf_counter()
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            if handle is not fdb:
                handle.close()  # stop the per-proc writer pool (fdb stays open)

    threads = [threading.Thread(target=proc, args=(m,)) for m in range(spec.n_procs)]
    wall0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - wall0
    if errors:
        raise errors[0]
    span = max(ends) - min(starts)
    # bandwidths count bytes SERVED: the retrieve phase moves read_mult×
    # the archived volume (dissemination fan-out)
    mult = max(1, spec.read_mult) if mode == "retrieve" else 1
    nbytes = spec.total_bytes * mult if mode != "list" else 0
    res = {
        "mode": mode,
        "io": spec.io,
        "global_span_s": span,
        "wall_s": wall,
        # application (pre-codec) bytes over global time — the bandwidth
        # that matters operationally (GRIB traffic is always packed)
        "bandwidth_GiBps": (nbytes / span / GiB) if nbytes else 0.0,
        "fields": spec.fields_per_proc * spec.n_procs * mult,
        "us_per_field": 1e6 * span / max(1, spec.fields_per_proc * spec.n_procs * mult),
    }
    if spec.codec_nbits is not None and nbytes:
        wire = spec.total_wire_bytes * mult
        res["effective_GiBps"] = res["bandwidth_GiBps"]
        res["wire_GiBps"] = wire / span / GiB
        res["codec_ratio"] = spec.total_bytes / wire
    return res


def sweep(spec: HammerSpec, backends=("daos", "posix"), lanes_sweep=(1, 2),
          trace_sink: list | None = None, cache_bytes: int | None = None) -> list[dict]:
    """Run the same spec through every io mode and lane count on each
    backend (fresh backend per cell), archive then retrieve.  With
    ``cache_bytes`` each cell runs through a dissemination cache tier and
    reports hit rate + backend bytes saved (pair with ``spec.read_mult`` for
    the read-mostly A/B against a cacheless run)."""
    import tempfile

    rows = []
    for backend in backends:
        for lanes in lanes_sweep:
            for io in IO_MODES:
                cell = replace(spec, io=io, n_datasets=max(spec.n_datasets, lanes))
                with tempfile.TemporaryDirectory() as td:
                    fdb = make_backend(backend, root=td, engine=None, lanes=lanes,
                                       codec_nbits=spec.codec_nbits,
                                       cache_bytes=cache_bytes)
                    drain = _trace_cell(fdb, f"{backend}-l{lanes}-{io}", trace_sink)
                    try:
                        w = run_hammer(fdb, cell, "archive")
                        r = run_hammer(fdb, cell, "retrieve")
                        cache = fdb.cache_snapshot() if cache_bytes is not None else None
                    finally:
                        drain()
                        fdb.close()
                row = {"backend": backend, "lanes": lanes, "io": io,
                       "write_GiBps": w["bandwidth_GiBps"],
                       "read_GiBps": r["bandwidth_GiBps"],
                       "us_per_field_w": w["us_per_field"]}
                if "codec_ratio" in w:
                    row["wire_GiBps_w"] = w["wire_GiBps"]
                    row["codec_ratio"] = w["codec_ratio"]
                if cache is not None:
                    row["hit_rate"] = cache["hit_rate"]
                    row["bytes_served_per_backend_byte"] = (
                        cache["bytes_served_per_backend_byte"]
                    )
                    row["backend_bytes_saved"] = (
                        cache["bytes_served"]  # served without a backend round
                    )
                rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# MARS request mode (--request): exercise the request language end to end
# ---------------------------------------------------------------------------

def run_request(fdb, request_text: str) -> dict:
    """Parse a MARS-style request (ranges, wildcards, partial requests) and
    retrieve it through the shared :class:`FDBClient` surface; full requests
    expand client-side, partial ones resolve via the level-pruned
    catalogue."""
    req = Request.parse(request_text)
    t0 = time.perf_counter()
    fieldset = fdb.retrieve_many(req)
    datas = fieldset.read_all()
    dt = time.perf_counter() - t0
    present = [v for v in datas.values() if v is not None]
    return {
        "request": req.format(),
        "matched_fields": len(fieldset),
        "present_fields": len(present),
        "bytes": sum(len(v) for v in present),
        "seconds": dt,
    }


# ---------------------------------------------------------------------------
# Declarative config mode (--config): the FDB under test from a JSON tree
# ---------------------------------------------------------------------------

#: the paper's tiered deployment as one declarative document: the first
#: ensemble member is the "operational hot" stream on DAOS NVM, everything
#: else lands on the cold POSIX archive — per-tier schemas use the paper's
#: per-backend optimal keyword placement (§5.1)
TIERED_CONFIG: dict = {
    "type": "select",
    "rules": [
        {"match": "number=0", "fdb": {"backend": "daos", "schema": "nwp-daos"}},
    ],
    "default": {"backend": "posix", "schema": "nwp-posix"},
}

#: the tiered deployment with the GRIB codec fused per tier: the hot DAOS
#: stream packs at 16 bits (NVM capacity is the scarce resource), the cold
#: POSIX archive keeps 24 bits of precision — one ``archive_fields`` call
#: routes, then each tier packs its own slice at its own width
TIERED_CODEC_CONFIG: dict = {
    "type": "select",
    "rules": [
        {
            "match": "number=0",
            "fdb": {
                "type": "codec", "nbits": 16,
                "inner": {"backend": "daos", "schema": "nwp-daos"},
            },
        },
    ],
    "default": {
        "type": "codec", "nbits": 24,
        "inner": {"backend": "posix", "schema": "nwp-posix"},
    },
}


def load_config(source: str) -> dict:
    """Resolve the ``--config`` argument: the built-in ``tiered`` /
    ``tiered-codec`` demos, inline JSON (starts with ``{``), or a path to a
    JSON file."""
    if source == "tiered":
        return json.loads(json.dumps(TIERED_CONFIG))  # deep copy
    if source == "tiered-codec":
        return json.loads(json.dumps(TIERED_CODEC_CONFIG))
    if source.lstrip().startswith("{"):
        return json.loads(source)
    with open(source) as f:
        return json.load(f)


def _fill_posix_roots(cfg, scratch: str, counter: list | None = None,
                      in_template: bool = False):
    """Give every local posix tier lacking a ``root`` its own directory
    under *scratch*, so a config document needs no machine-specific paths.
    Inside a ``dist`` template the filled root keeps a ``{lane}``
    placeholder — the template is instantiated once per lane, and lanes
    need independent roots (shared TOCs would duplicate every listing)."""
    counter = counter if counter is not None else [0]
    if isinstance(cfg, dict):
        is_local = cfg.get("type", "local" if "backend" in cfg else None) == "local"
        if is_local and cfg.get("backend") == "posix" and "root" not in cfg:
            import os

            root = os.path.join(scratch, f"tier{counter[0]}")
            cfg["root"] = os.path.join(root, "lane{lane}") if in_template else root
            counter[0] += 1
        for k, v in cfg.items():
            _fill_posix_roots(v, scratch, counter, in_template or k == "template")
    elif isinstance(cfg, list):
        for v in cfg:
            _fill_posix_roots(v, scratch, counter, in_template)
    return cfg


def run_config(config: dict, spec: HammerSpec, io_modes=IO_MODES,
               trace_sink: list | None = None) -> list[dict]:
    """Sweep one config-built FDB through the I/O modes: fresh tree +
    scratch roots per cell, archive then retrieve then a listing, with the
    per-tier/per-lane telemetry breakdown when the tree exposes one."""
    import copy
    import tempfile

    rows = []
    for io in io_modes:
        cell = replace(spec, io=io)
        with tempfile.TemporaryDirectory() as td:
            cfg = _fill_posix_roots(copy.deepcopy(config), td)
            with build_fdb(cfg) as fdb:
                drain = _trace_cell(fdb, f"config-{io}", trace_sink)
                for s in fdb.io_stats():
                    s.reset()  # a config may still name a shared/global sink
                w = run_hammer(fdb, cell, "archive")
                r = run_hammer(fdb, cell, "retrieve")
                n_step0 = sum(1 for _ in fdb.list({"step": "0"}))
                snap = fdb.stats_snapshot()
                drain()
        parts = snap.get("tiers") or snap.get("lanes") or []
        row = {
            "io": io,
            "write_GiBps": w["bandwidth_GiBps"],
            "read_GiBps": r["bandwidth_GiBps"],
            "us_per_field_w": w["us_per_field"],
            "listed_step0": n_step0,
            "n_parts": len(parts),
            "part_bytes_written": [p.get("bytes_written", 0) for p in parts],
            # effective (pre-codec) vs wire bytes from the merged telemetry:
            # equal on raw paths, effective > wire behind codec tiers (the
            # per-tier widths make the analytic formula inapplicable here,
            # so the STATS are the ground truth)
            "wire_bytes_written": snap.get("bytes_written", 0),
            "effective_bytes_written": snap.get("effective_bytes_written", 0),
            "effective_bytes_read": snap.get("effective_bytes_read", 0),
        }
        if spec.codec_nbits is not None:
            row["codec_ratio_w"] = (
                row["effective_bytes_written"] / row["wire_bytes_written"]
                if row["wire_bytes_written"] else 0.0
            )
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Contended client-scaling sweep (paper Figs 3/4)
# ---------------------------------------------------------------------------

def _proc_quanta(handle, spec: HammerSpec, member: int, mode: str, payload: bytes):
    """One hammer process as a generator of per-field backend quanta — the
    deterministic scheduler interleaves processes between quanta."""
    for step in range(spec.n_steps):
        keys = _step_keys(spec, member, step)
        if mode == "archive":
            if spec.codec_nbits is not None:
                # one grib_pack launch for the step batch, then one landing
                handle.archive_fields(keys, _step_fields(spec, member, step))
                yield
            elif spec.io == "batched":
                handle.archive_batch([(k, payload) for k in keys])
                yield
            else:
                for k in keys:
                    handle.archive(k, payload)
                    yield
            handle.flush()  # once per output step, as the I/O servers do
            yield
        elif mode == "retrieve":
            # dissemination fan-out: each repetition is its own quantum, so
            # the scheduler interleaves the N× read rounds across processes
            for _rep in range(max(1, spec.read_mult)):
                if spec.codec_nbits is not None:
                    arrs = handle.retrieve_fields(_step_request(spec, member, step)).arrays()
                    assert arrs.shape == (len(keys), *spec.field_shape)
                    yield
                elif spec.io == "batched":
                    datas = handle.read_batch(keys)
                    assert all(d is not None and len(d) == spec.field_size for d in datas)
                    yield
                else:
                    for k in keys:
                        data = handle.read(k)
                        assert data is not None and len(data) == spec.field_size
                        yield
        else:
            raise ValueError(mode)


def run_hammer_contended(fdb, spec: HammerSpec, mode: str, model) -> dict:
    """Drive ``spec.n_procs`` emulated processes through *fdb* under the
    contention *model* on its virtual clock.

    Deterministic discrete-event schedule: processes run as generators on
    ONE thread, and the process with the earliest virtual clock always
    executes its next quantum, so ops hit the model's resource timelines in
    near-arrival order (the gap-filling timelines absorb the within-quantum
    reordering) and the numbers are bit-identical on every run.  Bandwidths
    use global timing (paper §4.3) on the virtual clock.
    """
    import heapq

    payload = np.random.default_rng(0).bytes(spec.field_size)
    clients = [model.new_client(f"proc{m}") for m in range(spec.n_procs)]
    gens = [_proc_quanta(fdb, spec, m, mode, payload) for m in range(spec.n_procs)]
    heap: list[tuple[float, int]] = [(0.0, m) for m in range(spec.n_procs)]
    heapq.heapify(heap)
    since_prune = 0
    while heap:
        _, m = heapq.heappop(heap)
        with model.bind(clients[m]):
            try:
                next(gens[m])
            except StopIteration:
                continue
        heapq.heappush(heap, (clients[m].t, m))
        since_prune += 1
        if since_prune >= 256:  # bound timeline growth: nothing dispatches
            since_prune = 0     # before the earliest live clock
            model.prune(heap[0][0])
    span = max(c.t for c in clients)
    mult = max(1, spec.read_mult) if mode == "retrieve" else 1
    bytes_per_proc = spec.fields_per_proc * spec.field_size * mult
    per_proc = [bytes_per_proc / c.t / GiB for c in clients]
    res = {
        "mode": mode,
        "n_procs": spec.n_procs,
        "span_s": span,
        "agg_GiBps": spec.total_bytes * mult / span / GiB,
        "per_proc_GiBps": per_proc,
        "per_proc_GiBps_mean": sum(per_proc) / len(per_proc),
        "us_per_field": 1e6 * span / max(1, spec.fields_per_proc * spec.n_procs * mult),
    }
    if spec.codec_nbits is not None:
        # the contention model charges the WIRE bytes, but the run moved
        # total_bytes of application data: effective/wire is the codec win
        wire = spec.total_wire_bytes * mult
        res["effective_GiBps"] = res["agg_GiBps"]
        res["wire_GiBps"] = wire / span / GiB
        res["codec_ratio"] = spec.total_bytes / spec.total_wire_bytes
    return res


def _latency_summary(snapshot: dict) -> dict:
    return {
        op: {"p50_s": h["p50_s"], "p95_s": h["p95_s"], "p99_s": h["p99_s"], "count": h["count"]}
        for op, h in snapshot.get("latency", {}).items()
    }


def analytic_curve(backend: str, procs_list, spec: HammerSpec) -> list[dict]:
    """Cross-check curve from the closed-form bottleneck model
    (:mod:`repro.simulation.cluster`): same client scaling, steady state
    (large field count washes out the fixed startup term)."""
    from repro_torch.simulation.cluster import Workload, simulate

    rows = []
    for n in procs_list:
        w = Workload(
            n_server_nodes=1, n_client_nodes=1, procs_per_client=n,
            fields_per_proc=2000, field_size=spec.field_size, mode="write",
            contention=n > 1, n_opposing_procs=max(0, n - 1),
            flush_every=spec.n_params * spec.n_levels,
        )
        res = simulate("lustre" if backend == "posix" else "daos", w)
        rows.append(
            {"n_procs": n, "agg_GiBps": res.bandwidth_GiBps,
             "per_proc_GiBps": res.bandwidth_GiBps / n}
        )
    return rows


def find_knee(per_proc_curve: list[float], procs_list) -> int:
    """The contention knee: the client count with peak per-process
    bandwidth (degradation is monotone beyond it)."""
    i = max(range(len(per_proc_curve)), key=lambda j: per_proc_curve[j])
    return procs_list[i]


def read_slo_knee(per_proc_curve: list[float], procs_list, floor: float) -> int:
    """The read-side (dissemination) knee: the widest client count whose
    per-process read bandwidth still meets *floor* — half the uncontended
    single-client rate of the RAW backend, i.e. a fixed per-consumer
    service level.  The cache tier moves this right: hits are served at
    client-memory speed regardless of how many consumers pile on, so the
    count at which per-consumer service collapses below the SLO grows."""
    best = 0
    for n, bw in zip(procs_list, per_proc_curve):
        if bw >= floor:
            best = n
    return best


def scaling_sweep(
    spec: HammerSpec,
    backends=("posix", "daos"),
    procs_list=(1, 2, 4, 8, 16, 32),
    *,
    virtual: bool = True,
    out: str | None = "BENCH_contention_torch.json",
    codec_nbits: int | None = None,
    cache_bytes: int | None = None,
    trace_sink: list | None = None,
) -> dict:
    """The paper's client-scaling experiment: fresh backend + contention
    model per cell, archive then retrieve, per-proc and aggregate bandwidth
    plus latency percentiles from the metrics package; the analytical curve
    from :mod:`repro.simulation.cluster` rides along for cross-checking.
    Cells MERGE into an existing *out* document (matching
    :func:`remote_sweep`), so codec/cache/remote runs accumulate into one
    BENCH artifact.

    ``codec_nbits`` adds a codec cell per backend (labelled
    ``"<backend>+codec<n>"``, raw cells keep their plain labels): the same
    sweep through a :class:`CodecFDB` tier, reporting effective (pre-codec)
    vs wire bandwidth and their ratio — the compression win under
    contention.

    ``cache_bytes`` adds a ``"<backend>+cache"`` cell per backend: the same
    sweep through a :class:`~repro.cache.CacheFDB` dissemination tier, with
    hits charged at client-memory speed, reporting hit rate and bytes
    served per backend byte (set ``spec.read_mult > 1`` for the read-mostly
    A/B against the raw cell).  Every cell additionally reports the
    read-side SLO knee — the widest client count whose per-proc read
    bandwidth holds half the raw single-client rate."""
    import os
    import tempfile

    results: dict = {}
    if out and os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.setdefault("backends", {})
    results.update(
        spec=asdict(spec),
        virtual_clock=virtual,
        procs_list=list(procs_list),
        codec_nbits=codec_nbits,
        cache_bytes=cache_bytes,
    )
    cells: list[tuple[str, str, int | None, bool]] = []
    for backend in backends:
        cells.append((backend, backend, None, False))
        if codec_nbits is not None:
            cells.append((f"{backend}+codec{codec_nbits}", backend, codec_nbits, False))
        if cache_bytes is not None:
            cells.append((f"{backend}+cache", backend, None, True))
    for label, backend, nbits, cached in cells:
        rows = []
        for n in procs_list:
            cell = replace(spec, n_procs=n, codec_nbits=nbits)
            model = make_contention(backend, virtual=virtual)
            with tempfile.TemporaryDirectory() as td:
                stats = PosixStats(name=f"{label}-x{n}") if backend == "posix" else None
                fdb = make_backend(backend, root=td, engine=None, stats=stats,
                                   contention=model, codec_nbits=nbits,
                                   cache_bytes=cache_bytes if cached else None)
                # spans ride the MODEL's clock: each quantum runs bound to
                # one emulated client, so span times are that client's
                # virtual seconds — the exported trace shows the contended
                # schedule, not the (meaningless) wall time of the simulator
                drain = _trace_cell(fdb, f"{label}-x{n}", trace_sink,
                                    clock=lambda m=model: m.client().t)
                try:
                    w = run_hammer_contended(fdb, cell, "archive", model)
                    w["latency"] = _latency_summary(fdb.stats_snapshot())
                    for s in fdb.io_stats():
                        s.reset()
                    # the retrieve phase is a NEW epoch: its clients restart
                    # at t=0, so residual archive busy intervals must not
                    # queue phantom waits (writer registration — the lock
                    # holders reads conflict with — survives, as intended)
                    model.prune(float("inf"))
                    r = run_hammer_contended(fdb, cell, "retrieve", model)
                    r["latency"] = _latency_summary(fdb.stats_snapshot())
                    if cached:
                        r["cache"] = fdb.cache_snapshot()
                finally:
                    drain()
                    fdb.close()
            rows.append({"n_procs": n, "write": w, "read": r})
        per_proc = [row["write"]["per_proc_GiBps_mean"] for row in rows]
        results["backends"][label] = {
            "sweep": rows,
            "knee_n_procs": find_knee(per_proc, list(procs_list)),
            "analytic": analytic_curve(backend, procs_list, spec),
            "read_mult": spec.read_mult,
        }
        if nbits is not None:
            results["backends"][label]["codec_nbits"] = nbits
        if cached:
            results["backends"][label]["cache_bytes"] = cache_bytes
    # read-side SLO knee for this run's cells: floor = half the raw
    # single-client read rate of each cell's base backend
    for label, backend, _nbits, _cached in cells:
        raw = results["backends"].get(backend, {}).get("sweep", [])
        entry = results["backends"][label]
        curve = [row["read"]["per_proc_GiBps_mean"] for row in entry["sweep"]]
        floor = 0.5 * (raw[0]["read"]["per_proc_GiBps_mean"] if raw else curve[0])
        entry["read_slo_floor_GiBps"] = floor
        entry["read_slo_knee_n_procs"] = read_slo_knee(curve, list(procs_list), floor)
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
    return results


# ---------------------------------------------------------------------------
# Churn mode (--churn): lifecycle migration vs foreground traffic
# ---------------------------------------------------------------------------

def make_churn_tree(backend: str, root: str, model, spec: HammerSpec,
                    *, batch_size: int = 32):
    """The churn cell's FDB under test: a two-tier SelectFDB of the same
    backend family (the ``hot`` tier takes every archive by rule, ``cold``
    is the default) with a :class:`~repro.lifecycle.LifecycleFDB` above it
    demoting every output step but the newest.  BOTH tiers charge the SAME
    contention *model*, so migration I/O competes with the foreground
    hammer for the modelled hardware — that competition is the measurement.

    Returns ``(lifecycle_fdb, clk)``; *clk* is the mutable engine clock the
    churn loop advances to the migrator's virtual time (it stays 0 through
    the archive phase, so every field is immediately demotion-due once the
    migrator starts)."""
    import os

    if backend == "daos":
        # two engines = two namespaces (tiers must not share catalogues),
        # ONE model = one set of modelled NVM/fabric resources
        hot = make_fdb("daos", schema=NWP_SCHEMA_DAOS,
                       engine=DaosEngine(contention=model))
        cold = make_fdb("daos", schema=NWP_SCHEMA_DAOS,
                        engine=DaosEngine(contention=model))
    else:
        hot = make_fdb("posix", schema=NWP_SCHEMA_POSIX,
                       root=os.path.join(root, "hot"),
                       stats=PosixStats(name="churn-hot"), contention=model)
        cold = make_fdb("posix", schema=NWP_SCHEMA_POSIX,
                        root=os.path.join(root, "cold"),
                        stats=PosixStats(name="churn-cold"), contention=model)
    select = SelectFDB([("class=rd", hot, "hot")], default=cold)
    clk = [0.0]
    last_demoted = max(0, spec.n_steps - 2)
    lf = LifecycleFDB(
        select,
        [{"from": "hot", "to": "default", "max_age_s": 0.0,
          "match": f"step=0/to/{last_demoted}"}],
        clock=lambda: clk[0],
        batch_size=batch_size,
    )
    return lf, clk


def _churn_read_quanta(handle, spec: HammerSpec, member: int, counters: dict):
    """Foreground read stream for the churn phase: like the contended
    retrieve path, but read failures are COUNTED (the audit the cell
    publishes), not asserted — a failed read mid-migration is the bug the
    benchmark exists to rule out, so it must reach the report."""
    for step in range(spec.n_steps):
        keys = _step_keys(spec, member, step)
        for _rep in range(max(1, spec.read_mult)):
            datas = handle.read_batch(keys)
            for d in datas:
                if d is None or len(d) != spec.field_size:
                    counters["failed_reads"] += 1
            yield


def _migrator_quanta(lf: LifecycleFDB, clk: list, client, counters: dict):
    """The migration engine as one more discrete-event participant: each
    copy/flip/remove batch is a quantum charged to the migrator's own
    emulated client, and the engine re-scans until a pass moves nothing."""
    while True:
        clk[0] = client.t
        moved = 0
        for report in lf.migrate_steps():
            counters["fields_migrated"] += report.migrated
            counters["migration_batches"] += report.batches
            moved += report.migrated
            clk[0] = client.t
            yield
        if not moved:
            return
        yield


def run_hammer_churn(lf: LifecycleFDB, clk: list, spec: HammerSpec, model,
                     *, migrate: bool) -> dict:
    """The churn read phase: ``spec.n_procs`` foreground readers re-read
    every archived field under the contention model; with ``migrate`` the
    lifecycle engine joins the same deterministic schedule as an extra
    participant.  Bandwidths count FOREGROUND clients only — migration is
    overhead, and its cost shows up as their slowdown."""
    import heapq

    clients = [model.new_client(f"proc{m}") for m in range(spec.n_procs)]
    counters = {"failed_reads": 0, "fields_migrated": 0, "migration_batches": 0}
    gens = [_churn_read_quanta(lf, spec, m, counters) for m in range(spec.n_procs)]
    if migrate:
        mig = model.new_client("migrator")
        gens.append(_migrator_quanta(lf, clk, mig, counters))
        clients.append(mig)
    heap: list[tuple[float, int]] = [(0.0, i) for i in range(len(gens))]
    heapq.heapify(heap)
    since_prune = 0
    while heap:
        _, i = heapq.heappop(heap)
        with model.bind(clients[i]):
            try:
                next(gens[i])
            except StopIteration:
                continue
        heapq.heappush(heap, (clients[i].t, i))
        since_prune += 1
        if since_prune >= 256:
            since_prune = 0
            model.prune(heap[0][0])
    fg = clients[: spec.n_procs]
    span = max(c.t for c in fg)
    mult = max(1, spec.read_mult)
    bytes_per_proc = spec.fields_per_proc * spec.field_size * mult
    per_proc = [bytes_per_proc / c.t / GiB for c in fg]
    return {
        "mode": "retrieve",
        "migrate": migrate,
        "n_procs": spec.n_procs,
        "span_s": span,
        "agg_GiBps": spec.total_bytes * mult / span / GiB,
        "per_proc_GiBps_mean": sum(per_proc) / len(per_proc),
        **counters,
    }


def churn_sweep(
    spec: HammerSpec,
    backends=("posix", "daos"),
    procs_list=(1, 2, 4, 8),
    *,
    virtual: bool = True,
    out: str | None = "BENCH_contention_torch.json",
    batch_size: int = 32,
) -> dict:
    """The churn-interference experiment: per backend and client count, two
    runs on identical fresh trees — the baseline re-reads every field with
    the migration engine idle, the churn run does the same while the engine
    demotes all but the newest output step.  The ``"<backend>+churn"``
    cells MERGE into *out* next to the other sweeps and report foreground
    read bandwidth for both runs, their ratio (the interference), fields
    migrated, and the correctness audit: zero failed reads, zero duplicate
    listing entries (exactly one visible catalogue copy per field)."""
    import os
    import tempfile

    results: dict = {}
    if out and os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.setdefault("backends", {})
    results["churn_procs_list"] = list(procs_list)

    for backend in backends:
        label = f"{backend}+churn"
        rows = []
        for n in procs_list:
            cell = replace(spec, n_procs=n, io="batched")
            runs: dict[bool, dict] = {}
            for migrate in (False, True):
                model = make_contention(backend, virtual=virtual)
                with tempfile.TemporaryDirectory() as td:
                    lf, clk = make_churn_tree(backend, td, model, cell,
                                              batch_size=batch_size)
                    try:
                        run_hammer_contended(lf, cell, "archive", model)
                        for s in lf.io_stats():
                            s.reset()
                        # new epoch for the read phase (see scaling_sweep)
                        model.prune(float("inf"))
                        r = run_hammer_churn(lf, clk, cell, model, migrate=migrate)
                        # correctness audit: the merged listing must show
                        # every field exactly once, whichever tier owns it
                        seen = [tuple(sorted(e.key.items())) for e in lf.list({})]
                        r["listed_fields"] = len(seen)
                        r["duplicate_reads"] = len(seen) - len(set(seen))
                        if migrate:
                            r["overlay"] = lf.select.overlay_snapshot()
                    finally:
                        lf.close()
                runs[migrate] = r
            base, churn = runs[False], runs[True]
            rows.append({
                "n_procs": n,
                "read_GiBps_base": base["agg_GiBps"],
                "read_GiBps_churn": churn["agg_GiBps"],
                "interference_ratio": (
                    base["agg_GiBps"] / churn["agg_GiBps"]
                    if churn["agg_GiBps"] else float("inf")
                ),
                "fields_migrated": churn["fields_migrated"],
                "migration_batches": churn["migration_batches"],
                "failed_reads": base["failed_reads"] + churn["failed_reads"],
                "duplicate_reads": base["duplicate_reads"] + churn["duplicate_reads"],
                "base": base,
                "churn": churn,
            })
        results["backends"][label] = {
            "sweep": rows,
            "read_mult": spec.read_mult,
            "migration": True,
        }
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
    return results


# ---------------------------------------------------------------------------
# Remote mode (--remote): real client processes against the asyncio server
# ---------------------------------------------------------------------------

def _remote_proc_worker(addr: str, spec_kw: dict, member: int, mode: str):
    """One hammer client as a REAL OS process: its own RemoteFDB (own
    sockets, own GIL), one wire frame per output-step batch.  Module
    top-level so ``multiprocessing`` spawn can pickle it by reference.
    Returns wall-clock ``(start, end)`` — ``time.time()`` because the global
    timing span (paper §4.3) is computed ACROSS processes, and only the
    wall clock is shared between them."""
    spec = HammerSpec(**spec_kw)
    payload = np.random.default_rng(0).bytes(spec.field_size)
    from repro_torch.core.remote import RemoteFDB

    fdb = RemoteFDB(addr, timeout=300.0)
    try:
        # deliberately time.time(), NOT time.perf_counter(): perf_counter
        # epochs are per-process and these timestamps are differenced
        # across processes in run_hammer_remote
        t0 = time.time()
        for step in range(spec.n_steps):
            keys = _step_keys(spec, member, step)
            if mode == "archive":
                fdb.archive_batch([(k, payload) for k in keys])
                fdb.flush()  # once per output step, as the I/O servers do
            elif mode == "retrieve":
                datas = fdb.read_batch(keys)
                assert all(
                    d is not None and len(d) == spec.field_size for d in datas
                )
            else:
                raise ValueError(mode)
        return t0, time.time()
    finally:
        fdb.close()


def run_hammer_remote(addr: str, spec: HammerSpec, mode: str) -> dict:
    """Drive ``spec.n_procs`` REAL client processes against the FDB served
    at *addr*.  Spawn (not fork): the parent holds a CUDA context and an
    asyncio loop, neither survives forking.  Bandwidths use global timing
    across the processes' wall clocks."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    jobs = [(addr, asdict(spec), m, mode) for m in range(spec.n_procs)]
    with ctx.Pool(processes=spec.n_procs) as pool:
        times = pool.starmap(_remote_proc_worker, jobs)
    span = max(t1 for _, t1 in times) - min(t0 for t0, _ in times)
    span = max(span, 1e-9)
    bytes_per_proc = spec.fields_per_proc * spec.field_size
    per_proc = [bytes_per_proc / max(t1 - t0, 1e-9) / GiB for t0, t1 in times]
    return {
        "mode": mode,
        "n_procs": spec.n_procs,
        "span_s": span,
        "agg_GiBps": spec.total_bytes / span / GiB,
        "per_proc_GiBps": per_proc,
        "per_proc_GiBps_mean": sum(per_proc) / len(per_proc),
        "us_per_field": 1e6 * span / max(1, spec.fields_per_proc * spec.n_procs),
        "measured": True,
    }


def remote_sweep(
    spec: HammerSpec,
    backends=("posix", "daos"),
    procs_list=(1, 2, 4),
    *,
    out: str | None = "BENCH_contention_torch.json",
) -> dict:
    """Measured client-scaling cells: serve each backend behind an asyncio
    :class:`~repro.core.remote.FDBServer`, hammer it with real client
    processes, and MERGE the ``"<backend>+remote"`` cells (tagged
    ``"measured": true``) into *out* next to whatever simulated sweep is
    already there — the acceptance comparison reads both from one file."""
    import os
    import tempfile

    from repro_torch.core.remote import FDBServer

    results: dict = {}
    if out and os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.setdefault("backends", {})
    results.setdefault("spec", asdict(spec))
    results["remote_procs_list"] = list(procs_list)

    for backend in backends:
        label = f"{backend}+remote"
        rows = []
        for n in procs_list:
            cell = replace(spec, n_procs=n)
            with tempfile.TemporaryDirectory() as td:
                cfg = {"backend": backend}
                if backend == "posix":
                    cfg["root"] = td
                server = FDBServer(cfg)
                host, port = server.start()
                try:
                    addr = f"{host}:{port}"
                    w = run_hammer_remote(addr, cell, "archive")
                    r = run_hammer_remote(addr, cell, "retrieve")
                    wire = server.wire_stats.snapshot()
                finally:
                    server.stop()
            rows.append({
                "n_procs": n, "write": w, "read": r, "measured": True,
                "wire": {
                    "bytes_read": wire.get("bytes_read", 0),
                    "bytes_written": wire.get("bytes_written", 0),
                    "connections": len(wire.get("shard_ops", {})),
                },
            })
        per_proc = [row["write"]["per_proc_GiBps_mean"] for row in rows]
        results["backends"][label] = {
            "sweep": rows,
            "knee_n_procs": find_knee(per_proc, list(procs_list)),
            "measured": True,
        }
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True)
    return results


def _pow2_upto(n: int) -> list[int]:
    out = [1]
    while out[-1] * 2 <= n:
        out.append(out[-1] * 2)
    if out[-1] != n:
        out.append(n)
    return out


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--params", type=int, default=5)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--field-size", type=int, default=1 << 16)
    ap.add_argument("--backends", nargs="+", default=["daos", "posix"])
    ap.add_argument("--lanes", nargs="+", type=int, default=[1, 2])
    ap.add_argument("--scaling", action="store_true",
                    help="contended client-scaling sweep (1..procs, powers of two) "
                         "through the contention model on a virtual clock")
    ap.add_argument("--churn", action="store_true",
                    help="churn-interference sweep: per backend/client count, "
                         "re-read every field with the data-lifecycle engine "
                         "idle (baseline) and again while it demotes all but "
                         "the newest step between the tiers of a two-tier "
                         "select — '<backend>+churn' cells (foreground "
                         "bandwidth with/without migration, interference "
                         "ratio, audit counters) merge into the --out JSON")
    ap.add_argument("--remote", action="store_true",
                    help="MEASURED client-scaling sweep: serve each backend "
                         "behind the asyncio FDB server and hammer it with real "
                         "client processes (multiprocessing spawn, one RemoteFDB "
                         "per process); '<backend>+remote' cells merge into the "
                         "--out JSON next to any simulated sweep already there")
    ap.add_argument("--io", choices=IO_MODES, default="sync")
    ap.add_argument("--out", default="BENCH_contention_torch.json",
                    help="output JSON for --scaling")
    ap.add_argument("--request", default=None, metavar="MARS",
                    help="populate the backends, then retrieve this MARS-style "
                         'request through the shared client surface (e.g. '
                         '"step=0/to/4/by/2,param=*" — ranges, wildcards and '
                         "partial requests all work)")
    ap.add_argument("--config", default=None, metavar="JSON|PATH|tiered",
                    help="build the FDB under test from a declarative config "
                         "(repro.core.config grammar) and sweep it through the "
                         "io modes; 'tiered' is the built-in hot(DAOS)/cold("
                         "POSIX) select config, 'tiered-codec' the same with "
                         "per-tier GRIB codec widths, otherwise inline JSON or "
                         "a path to a JSON file (posix roots are auto-filled)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="collect distributed-trace spans from every cell "
                         "(wall clock; --scaling uses the contention model's "
                         "virtual clock) and write one Chrome trace-event "
                         "JSON — load it in Perfetto / chrome://tracing; "
                         "applies to the plain sweep, --config and --scaling")
    ap.add_argument("--codec-nbits", type=int, default=None, metavar="N",
                    help="drive the GRIB codec path: archive float32 fields "
                         "through archive_fields (one grib_pack launch per "
                         "step batch, N-bit codes) and decode on retrieve; "
                         "--scaling adds a '<backend>+codecN' cell per "
                         "backend reporting effective vs wire bandwidth")
    ap.add_argument("--read-mult", type=int, default=1, metavar="N",
                    help="read-mostly dissemination: retrieve every archived "
                         "field N times (bandwidths count bytes served); "
                         "works with and without --cache — the A/B cells")
    ap.add_argument("--cache", action="store_true",
                    help="wrap each FDB under test in the CacheFDB "
                         "dissemination tier (sharded read-through cache + "
                         "single-flight coalescing) and report hit rate and "
                         "bytes served per backend byte; --scaling adds a "
                         "'<backend>+cache' cell per backend with hits "
                         "charged at client-memory speed")
    ap.add_argument("--cache-bytes", type=int, default=256 << 20, metavar="B",
                    help="cache tier byte budget for --cache (default 256 MiB)")
    args = ap.parse_args()

    spec = HammerSpec(n_procs=args.procs, n_steps=args.steps, n_params=args.params,
                      n_levels=args.levels, field_size=args.field_size, io=args.io,
                      codec_nbits=args.codec_nbits, read_mult=args.read_mult)
    cache_bytes = args.cache_bytes if args.cache else None
    trace_sink: list | None = [] if args.trace else None

    def publish_trace() -> None:
        if args.trace and trace_sink is not None:
            from repro_torch.obs import write_chrome_trace

            n = write_chrome_trace(args.trace, trace_sink)
            print(f"wrote {n} trace events ({len(trace_sink)} spans) to {args.trace}")

    if args.config:
        config = load_config(args.config)
        label = "inline" if args.config.lstrip().startswith("{") else args.config
        print(f"fdb-hammer config mode ({label}): "
              f"{spec.n_procs} procs x {spec.fields_per_proc} fields x {spec.field_size} B\n")
        print(f"{'io':>8s} {'write GiB/s':>12s} {'read GiB/s':>11s} {'us/field(w)':>12s} "
              f"{'list(step=0)':>12s} {'tiers/lanes':>11s}")
        for row in run_config(config, spec, trace_sink=trace_sink):
            print(f"{row['io']:>8s} {row['write_GiBps']:12.3f} {row['read_GiBps']:11.3f} "
                  f"{row['us_per_field_w']:12.1f} {row['listed_step0']:12d} {row['n_parts']:11d}")
            if row["part_bytes_written"]:
                parts = ", ".join(f"{b / (1 << 20):.1f} MiB" for b in row["part_bytes_written"])
                print(f"{'':8s} per-part bytes written: {parts}")
            if "codec_ratio_w" in row:
                print(f"{'':8s} effective {row['effective_bytes_written'] / (1 << 20):.1f} MiB "
                      f"over wire {row['wire_bytes_written'] / (1 << 20):.1f} MiB "
                      f"(x{row['codec_ratio_w']:.2f} codec win)")
        publish_trace()
        return

    if args.request:
        import tempfile

        lanes = args.lanes[0]  # request mode is a single cell, not a sweep
        spec = replace(spec, n_datasets=max(spec.n_datasets, lanes))
        print(f"fdb-hammer request mode: {args.request!r} over "
              f"{spec.n_procs} procs x {spec.fields_per_proc} fields "
              f"(io={spec.io}, lanes={lanes})\n")
        print(f"{'backend':8s} {'matched':>8s} {'present':>8s} {'MiB':>8s} {'ms':>8s}")
        for backend in args.backends:
            with tempfile.TemporaryDirectory() as td:
                fdb = make_backend(backend, root=td, engine=None, lanes=lanes)
                try:
                    run_hammer(fdb, spec, "archive")
                    res = run_request(fdb, args.request)
                finally:
                    fdb.close()
            print(f"{backend:8s} {res['matched_fields']:8d} {res['present_fields']:8d} "
                  f"{res['bytes'] / (1 << 20):8.2f} {1e3 * res['seconds']:8.1f}")
        return

    if args.churn:
        procs_list = _pow2_upto(args.procs)
        print(f"fdb-hammer churn sweep (virtual clock): n_procs in {procs_list}, "
              f"{spec.fields_per_proc} fields x {spec.field_size} B per proc\n")
        results = churn_sweep(spec, backends=tuple(args.backends),
                              procs_list=procs_list, out=args.out)
        print(f"{'backend':14s} {'procs':>5s} {'base GiB/s':>11s} {'churn GiB/s':>12s} "
              f"{'interference':>12s} {'migrated':>9s} {'failed':>7s} {'dups':>5s}")
        for backend in args.backends:
            data = results["backends"][f"{backend}+churn"]
            for row in data["sweep"]:
                print(f"{backend + '+churn':14s} {row['n_procs']:5d} "
                      f"{row['read_GiBps_base']:11.3f} {row['read_GiBps_churn']:12.3f} "
                      f"{row['interference_ratio']:12.3f} {row['fields_migrated']:9d} "
                      f"{row['failed_reads']:7d} {row['duplicate_reads']:5d}")
        print(f"\nmerged churn cells into {args.out}")
        return

    if args.remote:
        procs_list = _pow2_upto(args.procs)
        print(f"fdb-hammer remote sweep (real processes): n_procs in {procs_list}, "
              f"{spec.fields_per_proc} fields x {spec.field_size} B per proc\n")
        results = remote_sweep(spec, backends=tuple(args.backends),
                               procs_list=procs_list, out=args.out)
        print(f"{'backend':16s} {'procs':>5s} {'write agg':>10s} {'write/proc':>11s} "
              f"{'read/proc':>10s} {'conns':>6s}")
        for backend in args.backends:
            data = results["backends"][f"{backend}+remote"]
            for row in data["sweep"]:
                w, r = row["write"], row["read"]
                print(f"{backend + '+remote':16s} {row['n_procs']:5d} "
                      f"{w['agg_GiBps']:10.3f} {w['per_proc_GiBps_mean']:11.3f} "
                      f"{r['per_proc_GiBps_mean']:10.3f} "
                      f"{row['wire']['connections']:6d}")
            print(f"{backend + '+remote':16s} knee at n_procs={data['knee_n_procs']}")
        print(f"\nmerged measured cells into {args.out}")
        return

    if args.scaling:
        procs_list = _pow2_upto(args.procs)
        print(f"fdb-hammer scaling sweep (virtual clock): n_procs in {procs_list}, "
              f"{spec.fields_per_proc} fields x {spec.field_size} B per proc\n")
        results = scaling_sweep(spec, backends=tuple(args.backends),
                                procs_list=procs_list, out=args.out,
                                codec_nbits=args.codec_nbits,
                                cache_bytes=cache_bytes,
                                trace_sink=trace_sink)
        print(f"{'backend':16s} {'procs':>5s} {'write agg':>10s} {'write/proc':>11s} "
              f"{'read/proc':>10s} {'w p99 us':>9s} {'eff/wire':>9s} {'hit rate':>9s}")
        for backend, data in results["backends"].items():
            for row in data["sweep"]:
                w, r = row["write"], row["read"]
                p99 = max((v["p99_s"] for v in w["latency"].values()), default=0.0)
                ratio = f"{w['codec_ratio']:9.2f}" if "codec_ratio" in w else f"{'-':>9s}"
                hits = (f"{r['cache']['hit_rate']:9.3f}" if "cache" in r
                        else f"{'-':>9s}")
                print(f"{backend:16s} {row['n_procs']:5d} {w['agg_GiBps']:10.3f} "
                      f"{w['per_proc_GiBps_mean']:11.3f} {r['per_proc_GiBps_mean']:10.3f} "
                      f"{1e6 * p99:9.1f} {ratio} {hits}")
            knee = data.get("read_slo_knee_n_procs")
            extra = f", read SLO knee at n_procs={knee}" if knee is not None else ""
            print(f"{backend:16s} knee at n_procs={data['knee_n_procs']}{extra}")
        print(f"\nwrote {args.out}")
        publish_trace()
        return

    mult = f" x{spec.read_mult} reads" if spec.read_mult > 1 else ""
    tier = f" (+cache {args.cache_bytes >> 20} MiB)" if args.cache else ""
    print(f"fdb-hammer: {spec.n_procs} procs x {spec.fields_per_proc} fields "
          f"x {spec.field_size} B  ({spec.total_bytes / GiB:.3f} GiB){mult}{tier}\n")
    print(f"{'backend':8s} {'lanes':>5s} {'io':>8s} {'write GiB/s':>12s} "
          f"{'read GiB/s':>11s} {'us/field(w)':>12s} {'hit rate':>9s} {'served/be':>10s}")
    for row in sweep(spec, backends=tuple(args.backends), lanes_sweep=tuple(args.lanes),
                     trace_sink=trace_sink, cache_bytes=cache_bytes):
        hits = f"{row['hit_rate']:9.3f}" if "hit_rate" in row else f"{'-':>9s}"
        served = (f"{row['bytes_served_per_backend_byte']:10.2f}"
                  if "bytes_served_per_backend_byte" in row else f"{'-':>10s}")
        print(f"{row['backend']:8s} {row['lanes']:5d} {row['io']:>8s} "
              f"{row['write_GiBps']:12.3f} {row['read_GiBps']:11.3f} "
              f"{row['us_per_field_w']:12.1f} {hits} {served}")
    publish_trace()


if __name__ == "__main__":
    main()
