"""One benchmark per paper table/figure.

fig3  — parameter optimisation: bandwidth vs client:server ratio × procs/node
        (simulator, no w+r contention)                         [paper Fig. 3]
fig4  — short scaling (2 000 fields/proc), ±contention         [paper Fig. 4]
fig5  — profiling breakdown of fdb-hammer/DAOS writer+reader time by DAOS
        API call (REAL backend, engine op_time stats)          [paper Fig. 5]
fig6  — long scaling (10 000 fields/proc), ±contention         [paper Fig. 6]
listing — fdb-hammer list() POSIX vs DAOS (REAL backends)      [paper §5.3]
churn — foreground read bandwidth vs client count with and without online
        tier migration (REAL backends under the contention model): the
        data-lifecycle engine demotes aged steps hot→cold while the
        foreground re-reads everything — the gap is the interference

Simulated figures are produced by the calibrated bottleneck model
(repro.simulation) and are labelled `sim`; fig5/listing run the real code.
"""

from __future__ import annotations

import csv
import os
import tempfile
import time

from repro_torch.core.daos import DaosEngine
from repro_torch.simulation import Workload, simulate

from .fdb_hammer_torch import HammerSpec, make_backend, run_hammer

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts", "bench_torch")


def _writer(name: str, header: list[str]):
    os.makedirs(ART, exist_ok=True)
    f = open(os.path.join(ART, f"{name}.csv"), "w", newline="")
    w = csv.writer(f)
    w.writerow(header)
    return f, w


def fig3_parameter_optimisation() -> list[dict]:
    """Bandwidth vs client:server-node ratio × procs/node, 8 server nodes."""
    rows = []
    f, w = _writer("fig3_parameter_optimisation", ["backend", "mode", "ratio", "procs_per_node", "GiBps"])
    for backend in ("daos", "lustre"):
        for mode in ("write", "read"):
            for ratio in (1, 2, 3):
                for ppn in (8, 16, 32, 48):
                    wl = Workload(
                        n_server_nodes=8, n_client_nodes=8 * ratio, procs_per_client=ppn,
                        fields_per_proc=2000, mode=mode,
                    )
                    bw = simulate(backend, wl).bandwidth_GiBps
                    rows.append({"backend": backend, "mode": mode, "ratio": ratio, "ppn": ppn, "GiBps": bw})
                    w.writerow([backend, mode, ratio, ppn, f"{bw:.2f}"])
    f.close()
    return rows


def _scaling(fields_per_proc: int, name: str) -> list[dict]:
    rows = []
    f, w = _writer(name, ["backend", "mode", "contention", "server_nodes", "GiBps"])
    for n in (1, 2, 4, 8, 12, 16):
        clients = 2 * n
        for backend in ("daos", "lustre"):
            for mode in ("write", "read"):
                nc = Workload(n_server_nodes=n, n_client_nodes=clients,
                              procs_per_client=32, fields_per_proc=fields_per_proc, mode=mode)
                rows.append({"backend": backend, "mode": mode, "contention": False,
                             "n": n, "GiBps": simulate(backend, nc).bandwidth_GiBps})
                half = max(1, clients // 2)
                ct = Workload(n_server_nodes=n, n_client_nodes=half, procs_per_client=32,
                              fields_per_proc=fields_per_proc, mode=mode,
                              contention=True, n_opposing_procs=half * 32)
                rows.append({"backend": backend, "mode": mode, "contention": True,
                             "n": n, "GiBps": simulate(backend, ct).bandwidth_GiBps})
    for r in rows:
        w.writerow([r["backend"], r["mode"], r["contention"], r["n"], f"{r['GiBps']:.2f}"])
    f.close()
    return rows


def fig4_short_scaling() -> list[dict]:
    return _scaling(2000, "fig4_short_scaling")


def fig6_long_scaling() -> list[dict]:
    return _scaling(10000, "fig6_long_scaling")


def fig5_profiling() -> dict:
    """fdb-hammer/DAOS time-per-API-call breakdown (paper Fig. 5).

    Runs the REAL backend to collect exact per-op counts/bytes, then costs
    each op with the network/media model (in-memory emulation time would
    reflect Python, not OmniPath+Optane).  Matches the paper's headline:
    daos_array_write / daos_array_read dominate, with visible one-off pool/
    container-connection overhead in short runs.
    """
    from repro_torch.core.costmodel import DEFAULT_DAOS as C

    per_op = {
        "daos_kv_put": C.rtt_s + C.kv_op_s,
        "daos_kv_get": C.rtt_s + C.kv_op_s,
        "daos_kv_list": C.rtt_s + 4 * C.kv_op_s,
        "daos_array_write": C.rtt_s + C.array_op_s,
        "daos_array_read": C.rtt_s + C.array_op_s,
        "daos_array_open_with_attrs": C.rtt_s + C.array_op_s,
        "daos_array_create": C.rtt_s + C.array_op_s,
        "daos_cont_alloc_oids": C.rtt_s + C.kv_op_s,
        # one-off establishment costs are milliseconds (paper Fig. 5)
        "daos_pool_connect": 120e-3,
        "daos_cont_create": 8e-3,
        "daos_cont_open": 5e-3,
    }
    engine = DaosEngine()
    fdb = make_backend("daos", engine=engine)
    spec = HammerSpec(n_procs=4, n_steps=4, n_params=5, n_levels=4, field_size=1 << 20)

    def modeled(stats) -> dict:
        snap = stats.snapshot()
        t = {op: n * per_op.get(op, C.rtt_s) for op, n in snap["ops"].items()}
        # bulk transfer time rides on the array ops
        if "daos_array_write" in t:
            t["daos_array_write"] += snap["bytes_written"] / C.client_bw_Bps * 4  # 4 procs share a NIC
        if "daos_array_read" in t:
            t["daos_array_read"] += snap["bytes_read"] / C.client_bw_Bps * 4
        return t

    engine.stats.reset()
    run_hammer(fdb, spec, "archive")
    writer_times = modeled(engine.stats)
    engine.stats.reset()
    run_hammer(fdb, spec, "retrieve")
    reader_times = modeled(engine.stats)

    f, w = _writer("fig5_profiling", ["phase", "op", "share_pct"])
    out = {}
    for phase, times in (("writer", writer_times), ("reader", reader_times)):
        total = sum(times.values()) or 1.0
        shares = {op: 100.0 * t / total for op, t in sorted(times.items(), key=lambda kv: -kv[1])}
        out[phase] = shares
        for op, pct in shares.items():
            w.writerow([phase, op, f"{pct:.1f}"])
    f.close()
    return out


def listing_comparison() -> dict:
    """list() on identical content: POSIX single-read segments vs DAOS
    per-entry kv_get (paper §5.3: POSIX consistently ~2× faster)."""
    spec = HammerSpec(n_procs=4, n_steps=4, n_params=6, n_levels=5, field_size=4096)
    results = {}
    with tempfile.TemporaryDirectory() as td:
        for backend in ("daos", "posix"):
            fdb = make_backend(backend, root=os.path.join(td, "fdb"))
            run_hammer(fdb, spec, "archive")
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                n = sum(1 for _ in fdb.list({"step": "0"}))
            dt = (time.perf_counter() - t0) / reps
            results[backend] = {"list_s": dt, "entries": n}
    f, w = _writer("listing_comparison", ["backend", "list_s", "entries"])
    for b, r in results.items():
        w.writerow([b, f"{r['list_s']:.5f}", r["entries"]])
    f.close()
    results["posix_speedup"] = results["daos"]["list_s"] / max(results["posix"]["list_s"], 1e-9)
    return results


def hammer_bandwidths() -> list[dict]:
    """Real-backend micro-bandwidths (laptop scale, labelled as such)."""
    spec = HammerSpec(n_procs=4, n_steps=4, n_params=5, n_levels=4, field_size=1 << 18)
    rows = []
    with tempfile.TemporaryDirectory() as td:
        for backend in ("daos", "posix"):
            fdb = make_backend(backend, root=os.path.join(td, "fdb"))
            for mode in ("archive", "retrieve"):
                r = run_hammer(fdb, spec, mode)
                rows.append({"backend": backend, **r})
    f, w = _writer("hammer_real_backends", ["backend", "mode", "GiBps", "us_per_field"])
    for r in rows:
        w.writerow([r["backend"], r["mode"], f"{r['bandwidth_GiBps']:.3f}", f"{r['us_per_field']:.1f}"])
    f.close()
    return rows


def churn_interference() -> list[dict]:
    """Foreground read bandwidth vs client count, with and without online
    tier migration (the churn panel): per backend and n_procs, the baseline
    re-reads every archived field with the lifecycle engine idle, the churn
    run does the same while the engine demotes all but the newest output
    step between the tiers of a two-tier select on a shared contention
    model.  The audit columns must be zero — migration may slow readers
    down (the interference ratio), never break them."""
    from .fdb_hammer_torch import churn_sweep

    spec = HammerSpec(n_steps=3, n_params=3, n_levels=2, field_size=1 << 16)
    results = churn_sweep(spec, backends=("posix", "daos"),
                          procs_list=(1, 2, 4, 8), out=None)
    rows = []
    f, w = _writer("churn_interference",
                   ["backend", "n_procs", "base_GiBps", "churn_GiBps",
                    "interference_ratio", "fields_migrated", "failed_reads",
                    "duplicate_reads"])
    for backend in ("posix", "daos"):
        for row in results["backends"][f"{backend}+churn"]["sweep"]:
            rows.append({"backend": backend, **row})
            w.writerow([
                backend, row["n_procs"], f"{row['read_GiBps_base']:.3f}",
                f"{row['read_GiBps_churn']:.3f}",
                f"{row['interference_ratio']:.3f}", row["fields_migrated"],
                row["failed_reads"], row["duplicate_reads"],
            ])
    f.close()
    return rows
