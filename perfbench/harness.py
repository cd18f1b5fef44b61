"""Finds a cell's parts by name, runs it once and prints its result.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

- the configuration, in the file its ``configs`` entry names;
- the traffic mix, ``traffic/<traffic>.json``, which names its driver,
  ``drivers/<driver>.py``;
- the limits of the comparison that decides ``correct``,
  ``limits/<workload>.json``;
- the plain reference of the configuration's family, ``reference/<family>.py``;
- each per-layer metric's reader, ``metrics/<metric>.py``.

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none.  A driver's ``run(cell)`` returns an
:class:`Outcome`; this module turns it into the result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

FOLDER = Path(__file__).resolve().parent
#: top-level module names that no run may load (the JAX package is ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    chips: int = 1
    device: str = "cuda"
    folder: Path = FOLDER
    #: process start on ``time.perf_counter``: set-up runs from here to the window
    t_start: float = field(default_factory=time.perf_counter)


@dataclass
class Outcome:
    """What a driver measured and checked in one run."""
    end_to_end: dict            # metric name -> value, on the host clock
    window_start: float         # time.perf_counter at the window's start
    attempted: int
    failed: int
    checks: dict                # number compared -> value
    memory_peak: int            # bytes, the card's peak before the check ran
    readings: dict              # what the per-layer readers read
    setup_parts: dict = field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, folder: Path = FOLDER):
    """``<folder>/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = folder / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def make_cell(bench: dict, root: Path, workload: str, seed: int, seconds: float, trace: bool,
              folder: Path = FOLDER, device: str = "cuda") -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(by_name)}")
    w = by_name[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=workload, workload=w, config=load_json(root / config["file"]),
                mix=load_json(folder / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(folder / "limits" / f"{workload}.json"), seed=seed,
                seconds=seconds, trace=trace, chips=w["chips"], device=device, folder=folder)


def port_config(cell: Cell):
    """The program's ``ModelConfig`` of the cell: the configuration file's
    ``port`` entry with the mix's ``port`` settings over it."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

    kw = {**cell.config["port"], **cell.mix.get("port", {})}
    for key, kind in (("ssm", SSMConfig), ("moe", MoEConfig)):
        if key in kw:
            kw[key] = kind(**kw[key])
    return ModelConfig(**kw)


def check_layout(shapes: dict, program_tree: dict) -> None:
    """The reference's parameter tree and the program's hold the same names
    and shapes, so the same weights mean the same model on both sides."""
    def walk(a, b, path):
        if isinstance(a, dict):
            if set(a) != set(b):
                raise ValueError(f"{path or 'params'}: reference has {sorted(a)}, program {sorted(b)}")
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            if len(a) != len(b):
                raise ValueError(f"{path}: reference has {len(a)} layers, program {len(b)}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}.{i}")
        elif tuple(a[0]) != tuple(b.shape):
            raise ValueError(f"{path}: reference shape {a[0]}, program {tuple(b.shape)}")
    walk(shapes, program_tree, "")


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct when every one is
    finite and within its limit and none is missing."""
    table = {}
    ok = True
    for name, spec in limits["checks"].items():
        value = checks.get(name)
        table[name] = {"value": value, "limit": spec["limit"]}
        ok = ok and value is not None and math.isfinite(value) and value <= spec["limit"]
    return ok, table


def result(bench: dict, cell: Cell, outcome: Outcome, device: dict) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or its
    per-layer metrics (``--trace 1``), each with its unit."""
    metrics = {}
    if not cell.trace:
        setup_s = outcome.window_start - cell.t_start
        for entry in bench["end_to_end"]:
            if applies(entry, cell.name):
                value = setup_s if entry["name"] == "setup_s" else outcome.end_to_end.get(entry["name"])
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in bench["per_layer"]:
            if applies(entry, cell.name):
                value = load_module("metrics", entry["name"], cell.folder).read(outcome.readings)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    correct, table = judge(outcome.checks, cell.limits)
    correct = correct and outcome.attempted > 0 and outcome.failed == 0
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    trace = outcome.readings.get("trace")
    if cell.trace and trace:
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checks"] = table
    return line


def main(argv: list[str], root: Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(root / "BENCHMARK.json")
    cell = make_cell(bench, root, args.workload, args.seed % 2**63, args.seconds, bool(args.trace))
    cell.t_start = t_start
    if not (root / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"perfbench: the program (src/repro_torch) is not in {root}", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    outcome = load_module("drivers", cell.mix["driver"]).run(cell)
    found = forbidden_loaded()
    if found:
        print(f"perfbench: the run loaded {found}; no module of JAX or of the JAX package may load",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak}
    trace = outcome.readings.get("trace")
    if cell.trace:
        if not trace or trace["busy_s"] <= 0:
            print("perfbench: the device trace holds no operation of the card", file=sys.stderr)
            return 5
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    line = result(bench, cell, outcome, device)
    print(json.dumps({"setup_parts": outcome.setup_parts}), file=sys.stderr)
    for name, row in line["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
