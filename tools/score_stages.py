"""Card time by named stage of the port's scoring path, on one CUDA card.

    python3 tools/score_stages.py [--workload mamba2-370m.score] [--seed 5772156649015]
                                  [--batches 3] [--out stages.json]

Builds a cell of the benchmark (``BENCHMARK.json``, ``perfbench/``) as the
cell's scoring module does: the seed's weights on the card and its pool of
pinned batches.
It scores the cell's warm-up batches, times ``--batches`` more without a
profiler, then scores as many again under ``torch.profiler`` over the host
and the card.  Each of the card's operations is counted under the stage of
``repro_torch.obs.stages`` that was open on the host thread of the runtime
call that launched it (the call with the operation's correlation id), and
under ``(none)`` where no stage was open.  The card's side of the stages'
ranges and every host event are left out, so the total is the card's
operations alone.

Prints card seconds by stage, with the kernels that took most of each, the
shares of the stage groups ``conv`` (``ssm.conv``), ``scan_glue``
(``ssm.scan`` less K4's two launches), ``norm`` (``ssm.norm_in``,
``ssm.gate_norm``, ``model.final_norm``), ``head`` (``model.head_ce``),
``unstaged`` (``(none)``) and, in the published Zamba2's cell, ``shared``
(the shared blocks' five stages ``shared.attn_in``, ``shared.attn``,
``shared.attn_out``, ``shared.mlp`` and ``shared.linear``), and the seconds a
batch with and without the profiler; writes all of it as JSON to ``--out``
where one is given.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: the stage of an operation launched under no stage of the program
NO_STAGE = "(none)"
#: K4's two launches, which ``scan_glue`` leaves out of ``ssm.scan``
K4 = ("ssd_chunk_state", "ssd_chunk_scan")
GROUPS = {
    "conv": ("ssm.conv",),
    "scan_glue": ("ssm.scan",),
    "norm": ("ssm.norm_in", "ssm.gate_norm", "model.final_norm"),
    "head": ("model.head_ce",),
    "unstaged": (NO_STAGE,),
    "shared": ("shared.attn_in", "shared.attn", "shared.attn_out", "shared.mlp", "shared.linear"),
}
TOP = 6  # kernels listed under each stage


def card_ops(events) -> list[tuple[str, int, int, str]]:
    """(name, start ns, end ns, stage) of each of the card's operations among
    the profiler's kineto ``events``, the stage being the user range open on
    the host thread of the runtime call that launched it, at that call's
    start; :data:`NO_STAGE` for none.  The stages do not nest, so a thread's
    ranges are disjoint."""
    from torch.autograd import DeviceType

    runtime, ranges, ops = {}, {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append(e)
        elif e.is_user_annotation():
            start = e.start_ns()
            ranges.setdefault(e.start_thread_id(), []).append((start, start + e.duration_ns(), e.name()))
        elif e.linked_correlation_id() > 0:  # a runtime call (cudaLaunchKernel, ...) inside a PyTorch call
            runtime[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    for rs in ranges.values():
        rs.sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}
    out = []
    for e in ops:
        stage = NO_STAGE
        tid, t = runtime.get(e.correlation_id(), (None, 0))
        if tid in ranges:
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t < ranges[tid][i][1]:
                stage = ranges[tid][i][2]
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(), stage))
    return out


def by_stage(ops) -> dict:
    """Seconds of the operations by stage, each with its seconds by kernel
    name: ``{stage: {"s": ..., "kernels": {name: s}}}``."""
    table: dict = {}
    for name, a, b, stage in ops:
        row = table.setdefault(stage, {"s": 0.0, "kernels": {}})
        row["s"] += (b - a) / 1e9
        row["kernels"][name] = row["kernels"].get(name, 0.0) + (b - a) / 1e9
    return table


def shares(table: dict) -> dict:
    """Percent of all the operations' seconds taken by each of :data:`GROUPS`
    (``scan_glue`` without K4's launches); ``shared`` only where a shared
    block ran."""
    total = sum(row["s"] for row in table.values())
    out = {}
    for group, stages in GROUPS.items():
        if group == "shared" and not any(st in table for st in stages):
            continue
        s = sum(table[st]["s"] for st in stages if st in table)
        if group == "scan_glue" and "ssm.scan" in table:
            s -= sum(v for k, v in table["ssm.scan"]["kernels"].items() if any(p in k for p in K4))
        out[group] = 100.0 * s / total if total > 0 else 0.0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mamba2-370m.score")
    ap.add_argument("--seed", type=int, default=5772156649015)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.make_cell(bench, ROOT, args.workload, args.seed % 2**63, 0.0, False)
    scoring = harness.load_module("drivers", cell.mix["driver"])
    cfg, params, _, _, pool = scoring.build(cell)
    n = 0
    for _ in range(cell.mix["warmup_batches"]):
        scoring.score(params, cfg, pool, n, cell.device)
        n += 1

    def timed():
        nonlocal n
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.batches):
            scoring.score(params, cfg, pool, n, cell.device)
            n += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / args.batches

    plain_s = timed()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_s = timed()
    table = by_stage(card_ops(prof.profiler.kineto_results.events()))
    total = sum(row["s"] for row in table.values())
    share = shares(table)

    print(f"{cell.name}: {args.batches} batches of {cell.mix['batch']} x {cell.mix['seq']}, "
          f"{torch.cuda.get_device_name(0)}; card operations {total:.6f} s")
    print(f"{'stage':<18} {'card s':>10} {'share %':>9}  kernels that took most")
    for stage, row in sorted(table.items(), key=lambda kv: -kv[1]["s"]):
        top = sorted(row["kernels"].items(), key=lambda kv: -kv[1])[:TOP]
        print(f"{stage:<18} {row['s']:>10.6f} {100 * row['s'] / total:>9.4f}  "
              + "; ".join(f"{k[:60]} {v:.6f}" for k, v in top))
    print("shares %: " + ", ".join(f"{g} {v:.4f}" for g, v in share.items()))
    print(f"seconds a batch: {plain_s:.6f} without the profiler, {traced_s:.6f} with it "
          f"({100 * (traced_s / plain_s - 1):+.3f} %)")
    record = {"workload": cell.name, "seed": args.seed, "batches": args.batches,
              "device": torch.cuda.get_device_name(0), "ops_s": total, "shares": share,
              "stages": table, "batch_s": {"plain": plain_s, "profiled": traced_s}}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"ops_s": total, "stages_s": {k: v["s"] for k, v in table.items()}, "shares": share}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
