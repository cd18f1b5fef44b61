"""Bottleneck-model cluster simulator: FDB workloads on Lustre vs DAOS.

A laptop cannot host 16 storage nodes + 32 clients, so the scaling figures
(paper Figs 3/4/6) are reproduced by replaying the backends' per-field
operation recipes through the calibrated cost model
(:mod:`repro.core.costmodel`) and a capacity/latency bottleneck analysis:

    phase_time = max( server_bandwidth_time,
                      client_bandwidth_time,
                      mds_time               (Lustre only),
                      per_process_serial_time )

Contention mechanics — the paper's core claim, §2:

- **Lustre**: a reader crossing a writer's cached write locks triggers a
  blocking AST + lock round-trip per conflicting extent; the conflict rate
  per process grows with the number of opposing processes sharing the
  servers.  MDS ops serialise on a single metadata node.
- **DAOS**: MVCC resolves contention server-side; readers/writers never
  exchange locks.  Cost of contention is only target queueing (already in
  the bandwidth term).  Per-op TCP round-trips are *higher* than Lustre's
  PSM2 — DAOS wins under contention despite the slower network, exactly as
  measured in the paper.

The test system mirrors NEXTGenIO (§4.1): dual-socket nodes, 2 network
rails, ~6 GiB/s effective per-socket storage bandwidth, 12.5 GiB/s NICs.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import DEFAULT_DAOS, DEFAULT_LUSTRE, DaosCosts, LustreCosts

__all__ = ["Workload", "simulate", "SimResult"]

GiB = float(1 << 30)

#: client-side op pipelining (outstanding requests per process)
PIPELINE = 4.0


@dataclass(frozen=True)
class Workload:
    n_server_nodes: int
    n_client_nodes: int
    procs_per_client: int
    fields_per_proc: int
    field_size: int = 1 << 20
    mode: str = "write"              # 'write' | 'read'
    contention: bool = False         # opposing readers+writers active
    n_opposing_procs: int = 0        # procs on the other side (for conflicts)
    flush_every: int = 200           # fields between flushes (steps)

    @property
    def n_procs(self) -> int:
        return self.n_client_nodes * self.procs_per_client

    @property
    def total_bytes(self) -> int:
        return self.n_procs * self.fields_per_proc * self.field_size


@dataclass(frozen=True)
class SimResult:
    bandwidth_Bps: float
    phase_time_s: float
    terms: dict

    @property
    def bandwidth_GiBps(self) -> float:
        return self.bandwidth_Bps / GiB


def _daos_per_field_latency(w: Workload, c: DaosCosts) -> float:
    """Serial client-visible latency per field (excluding bandwidth)."""
    if w.mode == "write":
        # array open_with_attrs + array_write + catalogue kv_put (+ axis puts
        # amortised) ; OID allocation amortised over the cached range
        ops = [c.rtt_s + c.array_op_s, c.rtt_s + c.array_op_s, c.rtt_s + c.kv_op_s]
        ops.append((c.rtt_s + c.kv_op_s) / 64.0)  # amortised alloc/axis
    else:
        # catalogue kv_get (cached dataset/colloc handles) + array_read;
        # no get_size round trip (length rides in the location descriptor)
        ops = [c.rtt_s + c.kv_op_s, c.rtt_s + c.array_op_s]
    return sum(ops) / PIPELINE


def _lustre_per_field_latency(w: Workload, c: LustreCosts) -> float:
    if w.mode == "write":
        # buffered append to the private stream + amortised TOC append at
        # flush; own-extent lock is cached (one enqueue per stream chunk)
        ops = [c.rtt_s, c.lock_rtt_s / 32.0]
        ops.append((c.mds_op_s + c.lock_rtt_s) / w.flush_every)  # segment+TOC
    else:
        # locate via cached TOC/index (amortised) + read: read lock enqueue
        ops = [c.lock_rtt_s, c.rtt_s]
        ops.append(c.mds_op_s / 64.0)  # occasional open/stat
    return sum(ops) / PIPELINE


def simulate(backend: str, w: Workload, *, lustre: LustreCosts = DEFAULT_LUSTRE, daos: DaosCosts = DEFAULT_DAOS) -> SimResult:
    opposing_per_server = (
        w.n_opposing_procs / max(1, w.n_server_nodes) if w.contention else 0.0
    )
    if backend == "daos":
        per_node_bw = 2 * daos.engine_bw_Bps  # 2 engines (sockets) per node
        if w.contention:
            per_node_bw *= daos.rw_interference  # log-structured: mild mixing cost
        client_bw = min(daos.client_bw_Bps, w.procs_per_client * daos.per_proc_bw_Bps)
        per_field = _daos_per_field_latency(w, daos)
        # index KV ops queue at their target engine (metadata spread over ALL
        # engines — no dedicated MDS)
        ops_per_field = 2.0 if w.mode == "write" else 1.0
        total_kv_ops = w.n_procs * w.fields_per_proc * ops_per_field
        mds_time = total_kv_ops / (2 * w.n_server_nodes * daos.kv_op_rate)
        conflict_time = 0.0  # MVCC: server-side, lockless
    elif backend == "lustre":
        per_node_bw = 2 * lustre.ost_bw_Bps
        if w.mode == "read":
            # data scattered across per-writer streams: seeky reads (§5.3 b)
            per_node_bw *= lustre.read_bw_derate
        if w.contention:
            # mixed r/w interference: readers invalidate writers' cached
            # write locks; OST queue alternates flush/read
            per_node_bw /= 1.0 + opposing_per_server / lustre.rw_interference_k
        client_bw = min(lustre.client_bw_Bps, w.procs_per_client * lustre.per_proc_bw_Bps, lustre.node_protocol_cap_Bps)
        per_field = _lustre_per_field_latency(w, lustre)
        # one MDS node total: segment/TOC/open ops serialise there.  While
        # writers append, every reader retrieve re-polls the TOC (stat +
        # read-lock enqueue) — the dominant metadata load under contention.
        tail_rate = (
            lustre.toc_tail_rate_contended
            if (w.contention and w.mode == "read") or (w.contention and w.n_opposing_procs)
            else lustre.toc_tail_rate_quiet
        )
        mds_ops = w.n_procs * (
            w.fields_per_proc * tail_rate
            + w.fields_per_proc / 64.0
            + (w.fields_per_proc / w.flush_every) * 2.0
            + 2.0
        )
        mds_time = mds_ops * lustre.mds_op_s
        # lock conflicts: blocking ASTs per conflicting extent
        if w.contention and w.n_opposing_procs:
            conflict_rate = min(1.0, lustre.conflict_base * opposing_per_server / 16.0)
            per_conflict = lustre.lock_cancel_s + lustre.lock_rtt_s
            conflict_time = w.fields_per_proc * conflict_rate * per_conflict
        else:
            conflict_time = 0.0
    else:
        raise ValueError(backend)

    server_time = w.total_bytes / (w.n_server_nodes * per_node_bw)
    client_time = w.total_bytes / (w.n_client_nodes * client_bw)
    serial_time = w.fields_per_proc * per_field + conflict_time
    startup = 0.5 if backend == "daos" else 0.3  # pool/container vs mount overheads

    phase = max(server_time, client_time, mds_time, serial_time) + startup
    terms = {
        "server_bw_s": server_time,
        "client_bw_s": client_time,
        "mds_s": mds_time,
        "serial_s": serial_time,
        "conflict_s": conflict_time,
        "startup_s": startup,
    }
    return SimResult(bandwidth_Bps=w.total_bytes / phase, phase_time_s=phase, terms=terms)
