"""The harness on the CPU: BENCHMARK.json's shape, discovery by name, the
result line, a throwaway cell added from a temporary directory, and what
``run.py`` loads and refuses."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.FOLDER.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    n = len(cells)
    assert 2 + 14 * n * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == n
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        e2e = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, w["name"]) for m in BENCH["per_layer"])
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e_names and "\n" not in m["layer"]
        cells_of_moved = [w for w in cells if harness.applies(next(e for e in BENCH["end_to_end"]
                                                                  if e["name"] == m["moves"]), w)]
        assert set(m.get("workloads", cells)) <= set(cells_of_moved)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(workload):
    cell = harness.make_cell(BENCH, ROOT, workload, 1, 1.0, False)
    assert cell.config["name"] == cell.workload["config"]
    harness.load_module("drivers", cell.mix["driver"]).run  # noqa: B018
    harness.load_module("reference", cell.config["family"]).param_shapes  # noqa: B018
    assert set(cell.limits["checks"])
    for m in BENCH["per_layer"]:
        if harness.applies(m, workload):
            assert callable(harness.load_module("metrics", m["name"]).read)


def test_a_missing_part_is_named():
    with pytest.raises(KeyError, match="no workload"):
        harness.make_cell(BENCH, ROOT, "no-such.cell", 1, 1.0, False)
    with pytest.raises(FileNotFoundError, match="no metrics named"):
        harness.load_module("metrics", "no_such_metric")


def test_judge_and_the_result_line():
    cell = harness.make_cell(BENCH, ROOT, BENCH["workloads"][0]["name"], 1, 1.0, False)
    checks = {name: 0.0 for name in cell.limits["checks"]}
    out = harness.Outcome(end_to_end={"train_tokens_per_s": 5.0, "score_tokens_per_s": 6.0},
                          window_start=cell.t_start + 3.0, attempted=4, failed=0, checks=checks,
                          memory_peak=7, readings={"trace": None})
    line = harness.result(BENCH, cell, out, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": pytest.approx(3.0), "unit": "s"}
    for bad in (math.nan, math.inf, 1e9):
        name = next(iter(checks))
        ok, table = harness.judge({**checks, name: bad}, cell.limits)
        assert not ok and table[name]["value"] is bad
    assert not harness.judge({}, cell.limits)[0]


def run_py(cwd: Path, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_run_py_loads_neither_jax_nor_the_jax_package():
    code = ("import runpy, sys; sys.argv = ['perfbench/run.py']; "
            "runpy.run_path('perfbench/run.py', run_name='not_main'); "
            "import perfbench.drivers.score, perfbench.drivers.train, perfbench.calibrate, repro_torch.training; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_nothing_under_perfbench_reads_benchmarks_or_imports_the_program_from_the_reference():
    for path in (p for p in harness.FOLDER.rglob("*.py") if not p.name.startswith("test_")):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|flax|repro)\b(?!_torch)", text, re.M), path
        assert "benchmarks/" not in text and "from benchmarks" not in text, path
    for path in (harness.FOLDER / "reference").glob("*.py"):
        assert "repro_torch" not in path.read_text(), path


def test_run_py_without_a_card_exits_and_prints_no_result():
    out = run_py(ROOT, "--workload", "mamba2-370m.score", "--seed", "3", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_run_py_without_the_program_exits_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.FOLDER, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path, "--workload", "mamba2-370m.score", "--seed", "3", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
