"""The paper's operational workflow, end to end (§1.2 scaled to a laptop),
on the PyTorch/CUDA port.

An ensemble of model "I/O server" processes stream GRIB-packed fields into
the FDB while post-processing consumers read *transposed step slices* (all
members/params for step n) as soon as step n is flushed — writers and
readers run simultaneously: the contention pattern the paper targets.

Runs the same workflow on BOTH backends and in both I/O styles — ``sync``
(one round-trip per field, the seed path) and ``async`` (each I/O server
batch-archives a whole output step through an AsyncFDB writer pool; the
post-processor pulls each step slice as one batched read) — and reports
wall time + the backend op profile, then replays the op counts through the
cluster cost model for the at-scale picture.  The twin of
``examples/nwp_workflow.py``: the fields are GRIB-packed by the port's
hand-written CUDA kernel on the card, or by its plain PyTorch version when
the CPU is asked for.

    PYTHONPATH=src python examples/nwp_workflow_torch.py [--device cpu]
"""

import argparse
import tempfile
import threading
import time

from repro_torch.core import AsyncFDB, Key, NWP_SCHEMA_DAOS, NWP_SCHEMA_POSIX, Request, build_fdb, make_fdb
from repro_torch.fields import synthetic_field
from repro_torch.core.daos import DaosEngine
from repro_torch.core.posix.stats import POSIX_STATS
from repro_torch.device import resolve_device, set_default_device
from repro_torch.kernels.grib_pack import pack_to_bytes

N_MEMBERS = 4
N_STEPS = 6
PARAMS = ("2t", "10u", "10v", "msl")
FIELD_SHAPE = (64, 128)


def key(member: int, step: int, param: str) -> Key:
    return Key(
        {"class": "od", "stream": "oper", "expver": "0001", "date": "20240603",
         "time": "1200", "type": "ef", "levtype": "sfc", "number": str(member),
         "levelist": "0", "step": str(step), "param": param}
    )


def run_workflow(make, io: str = "sync") -> dict:
    """make: () -> FDB (fresh handle per process).  io: 'sync' | 'async'."""
    payloads = {}
    for p in PARAMS:
        f = synthetic_field(p, nlat=FIELD_SHAPE[0], nlon=FIELD_SHAPE[1])
        payloads[p], _ = pack_to_bytes(f)

    step_done = [threading.Event() for _ in range(N_STEPS)]
    flushed = [0] * N_STEPS  # members that have published step n
    lock = threading.Lock()
    errors = []

    def io_server(member: int) -> None:
        fdb = make()
        if io == "async":
            # writer pool keeps the step's fields in flight concurrently
            fdb = AsyncFDB(fdb, writers=2, batch_size=len(PARAMS), owns_fdb=True)
        try:
            with fdb:  # every facade is a context manager: close() flushes
                for step in range(N_STEPS):
                    if io == "async":
                        fdb.archive_batch([(key(member, step, p), payloads[p]) for p in PARAMS])
                    else:
                        for p in PARAMS:
                            fdb.archive(key(member, step, p), payloads[p])
                    fdb.flush()  # publish this member's step (the workflow
                    # controller learns availability exactly here — paper §1.2)
                    with lock:
                        flushed[step] += 1
                        if flushed[step] == N_MEMBERS:
                            step_done[step].set()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def post_processor() -> None:
        """Consumes step n as soon as every member flushed it (the
        transposed read: across ALL writers' streams, one step)."""
        try:
            with make() as fdb:
                for step in range(N_STEPS):
                    step_done[step].wait(timeout=60)
                    if io == "async":
                        # the whole transposed slice as ONE partial MARS request:
                        # members and params stay unspecified, the catalogue
                        # resolves them and the read comes back batched
                        fieldset = fdb.retrieve_many(Request.parse(f"step={step},param=*"))
                        datas = fieldset.read_all()
                        assert len(datas) == N_MEMBERS * len(PARAMS), f"short slice at step {step}"
                        assert all(d is not None for d in datas.values()), f"missing field in step {step}"
                    else:
                        for k in [key(m, step, p) for m in range(N_MEMBERS) for p in PARAMS]:
                            assert fdb.read(k) is not None, f"missing {dict(k)}"
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=io_server, args=(m,)) for m in range(N_MEMBERS)]
    threads.append(threading.Thread(target=post_processor))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {"wall_s": time.perf_counter() - t0,
            "fields": N_MEMBERS * N_STEPS * len(PARAMS)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    set_default_device(dev)  # where pack_to_bytes packs

    print(f"ensemble: {N_MEMBERS} members x {N_STEPS} steps x {len(PARAMS)} params, "
          f"GRIB-packed on {dev}, readers consume each step while the next is written\n")

    for io in ("sync", "async"):
        engine = DaosEngine()
        r = run_workflow(lambda: make_fdb("daos", schema=NWP_SCHEMA_DAOS, engine=engine), io=io)
        snap = engine.stats.snapshot()
        print(f"DAOS  ({io:5s}): {r['wall_s']*1e3:7.1f} ms  ops={sum(snap['ops'].values())} "
              f"(kv_put={snap['ops'].get('daos_kv_put',0)}, array_write={snap['ops'].get('daos_array_write',0)}, "
              f"eq_poll={snap['ops'].get('daos_eq_poll',0)})")

        with tempfile.TemporaryDirectory() as td:
            POSIX_STATS.reset()
            r = run_workflow(lambda: make_fdb("posix", schema=NWP_SCHEMA_POSIX, root=td), io=io)
            snap = POSIX_STATS.snapshot()
            print(f"POSIX ({io:5s}): {r['wall_s']*1e3:7.1f} ms  lock-acquisitions={snap['lock_acquisitions']} "
                  f"mds-ops={snap['mds_ops']}")

    # --- tiered hot/cold deployment from one declarative config -------------
    # the paper's operational layout: the live forecast stream (class=od)
    # lands on the hot DAOS tier (NVM), reanalysis/archive classes fall
    # through to the cold POSIX tier — one select config, per-tier schemas
    print("\ntiered hot/cold (select config): class=od -> DAOS, default -> POSIX")
    engine = DaosEngine()
    with tempfile.TemporaryDirectory() as td:
        tiered_cfg = {
            "type": "select",
            "rules": [{"match": "class=od",
                       "fdb": {"backend": "daos", "schema": "nwp-daos", "engine": engine}}],
            "default": {"backend": "posix", "schema": "nwp-posix", "root": td},
        }
        # the whole operational workflow runs against the select facade —
        # every field is class=od, so the hot tier takes all of it
        r = run_workflow(lambda: build_fdb(tiered_cfg), io="sync")
        with build_fdb(tiered_cfg) as tiered:
            # a reanalysis field routes to the cold tier without touching hot
            cold_key = Key({**dict(key(0, 99, "2t")), "class": "rd", "date": "19900101"})
            cold_payload, _ = pack_to_bytes(
                synthetic_field("2t", nlat=FIELD_SHAPE[0], nlon=FIELD_SHAPE[1]))
            tiered.archive(cold_key, cold_payload)
            tiered.flush()
            n_cold = sum(1 for _ in tiered.list(Request.parse("class=rd")))
            n_all = sum(1 for _ in tiered.list(Request.parse("param=2t")))
            # config-built posix tiers carry their OWN stats sink (not the
            # process-global one): read the cold tier's telemetry directly
            cold_snap = tiered.tiers[1].io_stats()[0].snapshot()
        hot_ops = sum(engine.stats.snapshot()["ops"].values())
        print(f"tiered: {r['wall_s']*1e3:7.1f} ms workflow on hot tier "
              f"({hot_ops} daos ops); cold tier holds {n_cold} field "
              f"({cold_snap['lock_acquisitions']} posix lock-acquisitions); "
              f"merged list(param=2t) sees {n_all} fields across both tiers")

    # at-scale projection through the calibrated cost model
    from repro_torch.simulation import Workload, simulate

    print("\nat 8 server nodes, w+r contention (cost model):")
    for backend in ("daos", "lustre"):
        w = Workload(n_server_nodes=8, n_client_nodes=8, procs_per_client=32,
                     fields_per_proc=10000, mode="write", contention=True,
                     n_opposing_procs=8 * 32)
        print(f"  {backend:7s}: {simulate(backend, w).bandwidth_GiBps:7.1f} GiB/s write under contention")


if __name__ == "__main__":
    main()
