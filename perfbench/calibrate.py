"""The readings that the limits of ``limits/<workload>.json`` are set from, at
a cell's own size on the card, in one process:

- sound runs of the program against the plain reference on many seeds (the
  lower reading of each number compared is the largest of these);
- the control, the reference itself in float8 in the program's place, on a
  few seeds (the upper reading is the smallest, where it is three times the
  lower or more);
- each fault of :mod:`perfbench.faults` that the cell can have, on a few seeds.

    python3 perfbench/calibrate.py --workload mamba2-370m.score --seeds 1 2 3 ... \
        --control-seeds 1 2 3 --out calibrate_score.json

Training's readings come from the trainer's first steps, scoring's from as
many batches as a run checks; neither needs a measured window.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402
from perfbench.drivers import score as score_driver  # noqa: E402
from perfbench.drivers import train as train_driver  # noqa: E402


def score_readings(cell: harness.Cell, seeds, control_seeds) -> list[dict]:
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        cell.seed = seed
        cfg, params, ref, shapes, pool = score_driver.build(cell)
        picked = list(range(cell.mix["check_batches"]))
        runs = {"program": None}
        runs.update({f: None for f in faults.BY_DRIVER["score"]} if seed in control_seeds else {})
        for what in runs:
            with faults.planted(what, "score") if what != "program" else contextlib.nullcontext():
                runs[what] = [score_driver.score(params, cfg, pool, i, cell.device) for i in picked]
        del params
        torch.cuda.empty_cache()
        expected = score_driver.reference_losses(cell, ref, shapes, pool, picked)
        row = {"seed": seed}
        for what, losses in runs.items():
            row[what] = {"loss_gap": max(abs(a - b) for a, b in zip(losses, expected))}
        if seed in control_seeds:
            fp8 = score_driver.reference_losses(cell, ref, shapes, pool, picked, quant="fp8")
            row["control"] = {"loss_gap": max(abs(a - b) for a, b in zip(fp8, expected))}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def train_readings(cell: harness.Cell, seeds, control_seeds) -> list[dict]:
    job = train_driver.Job(cell)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        row = {"seed": seed}
        progs = {"program": None}
        if seed in control_seeds:
            progs["half_batch"] = None
        for what in progs:
            job.load_weights(seed)
            with faults.planted(what, "train") if what != "program" else contextlib.nullcontext():
                progs[what] = job.first_steps(seed)
            job.free_state()
        t = time.perf_counter()
        ref = job.reference(seed)
        row["reference_s"] = time.perf_counter() - t
        for what, prog in progs.items():
            row[what] = train_driver.compare(prog, ref)
        row["program_detail"] = progs["program"]
        row["reference_detail"] = ref
        if seed in control_seeds:
            row["control"] = train_driver.compare(job.reference(seed, quant="fp8"), ref)
        torch.cuda.empty_cache()
        print(json.dumps({k: v for k, v in row.items() if not k.endswith("_detail")}), flush=True)
        out.append(row)
    job.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.make_cell(bench, ROOT, args.workload, 0, 0.0, False)
    torch.cuda.set_device(0)
    driver = cell.mix["driver"]
    rows = (score_readings if driver == "score" else train_readings)(cell, args.seeds, args.control_seeds)
    summary = {}
    for r in rows:
        for key, nums in r.items():
            if isinstance(nums, dict) and not key.endswith("_detail"):
                for name, v in nums.items():
                    got = summary.setdefault(f"{key}.{name}", {"max": v, "min": v, "n": 0})
                    got.update(max=max(got["max"], v), min=min(got["min"], v), n=got["n"] + 1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows, "summary": summary,
                                          "device": torch.cuda.get_device_name(0)}, indent=1))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
