"""Per-operation cost model: Lustre (POSIX) vs DAOS at cluster scale.

A laptop cannot exhibit Lustre's distributed-lock round-trips or DAOS's
server-side MVCC at 1000-node scale, so the benchmark harness replays the
backends' *operation counts* (see posix/stats.py, daos/engine.py) through
this model inside a discrete-event simulator (:mod:`repro.simulation`).

Constants are drawn from the paper's test system (NEXTGenIO, §4.1) and its
cited behaviour:

- OmniPath: 12.5 GiB/s per adapter; PSM2 (RDMA) RTT ≈ 2 µs for Lustre,
  TCP RTT ≈ 30 µs for DAOS (the paper notes DAOS could not use PSM2 and ran
  TCP — and still won under contention);
- Optane DCPMM: ~0.3 µs media latency, bandwidth folded into the server
  service rate;
- Lustre LDLM: every conflicting extent lock costs one RTT to the lock
  server *plus* queueing at the lock service; lock cancellations (writer
  cache invalidation under reader contention) cost another;
- Lustre MDS: opens/creates/stats serialise on one metadata node (the +1
  node in all the paper's Lustre deployments);
- DAOS: metadata spread over all engines; kv/array ops are one request to
  the target engine, contention resolved there without client round-trips.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "LustreCosts",
    "DaosCosts",
    "DEFAULT_LUSTRE",
    "DEFAULT_DAOS",
    "CACHE_HIT_S",
    "CACHE_BW_Bps",
]

GiB = float(1 << 30)

# Client-side read-cache tier (repro.cache): a hit never leaves the client
# node — no lock round-trips, no OST/engine queueing, just a local memory
# copy.  Fixed lookup overhead plus single-thread DRAM copy bandwidth;
# these are per-CLIENT serial costs, there is no shared service centre.
CACHE_HIT_S = 1.5e-6
CACHE_BW_Bps = 10.0 * GiB


@dataclass(frozen=True)
class LustreCosts:
    rtt_s: float = 2e-6                  # PSM2 RDMA round-trip
    lock_rtt_s: float = 12e-6            # LDLM enqueue (server work + RTT)
    lock_cancel_s: float = 25e-6         # blocking AST + cache writeback on conflict
    mds_op_s: float = 40e-6              # open/create/stat service time at the MDS
    ost_bw_Bps: float = 5.8 * GiB        # per-OST (per-socket SCM + adapter) bandwidth
    client_bw_Bps: float = 12.5 * GiB    # per-client-node adapter
    # PSM2/RDMA: few processes saturate the protocol ceiling (paper §5.1)
    per_proc_bw_Bps: float = 0.44 * GiB
    node_protocol_cap_Bps: float = 7.0 * GiB
    # probability a lock enqueue conflicts when readers+writers share extents
    conflict_base: float = 0.35
    # POSIX read pathway: data scattered across per-writer streams -> seeky
    # small reads; effective OST read bandwidth derate (paper §5.3 (b))
    read_bw_derate: float = 0.62
    # reader TOC tail (stat+read-lock) rate per retrieve: cache-hit when the
    # TOC is static, forced re-poll while writers append (paper §1.2)
    toc_tail_rate_quiet: float = 0.02
    toc_tail_rate_contended: float = 1.0
    # mixed read/write interference on an OST under w+r contention:
    # eff_bw = bw / (1 + opposing_procs_per_server / rw_interference_k)
    rw_interference_k: float = 32.0


@dataclass(frozen=True)
class DaosCosts:
    rtt_s: float = 30e-6                 # TCP round-trip (no PSM2 support, §4.1)
    kv_op_s: float = 8e-6                # server-side KV index insert/visit (SCM)
    array_op_s: float = 6e-6             # extent registration / index visit
    engine_bw_Bps: float = 5.2 * GiB     # per-engine (per-socket) bandwidth
    client_bw_Bps: float = 12.5 * GiB
    # TCP (no PSM2 support): per-process protocol ceiling — needs more
    # processes than Lustre to reach useful node bandwidth (paper §5.1)
    per_proc_bw_Bps: float = 0.17 * GiB
    kv_op_rate: float = 125_000.0        # KV index ops/s per engine
    # log-structured MVCC writes: mild interference under mixed r/w
    rw_interference: float = 0.93
    # MVCC: no client-visible locking; contention only queues at the target


DEFAULT_LUSTRE = LustreCosts()
DEFAULT_DAOS = DaosCosts()
