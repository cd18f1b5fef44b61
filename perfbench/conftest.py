"""A benchmark folder with throwaway cells at a tiny size, made in a temporary
directory by adding files and ``BENCHMARK.json`` entries alone: a float32
two-layer Mamba2, its two mixes, their limits (the real cells' own) and one
extra per-layer metric."""

import json
import shutil

import pytest

from perfbench import harness

TINY = {"d_model": 64, "n_layer": 2, "vocab_size": 256, "pad_vocab_size_multiple": 8, "dtype": "float32"}
TINY_LAYER = {"d_state": 16, "headdim": 16, "chunk_size": 32}
TINY_PORT = {"n_layers": 2, "d_model": 64, "vocab": 256, "pad_vocab_multiple": 8, "dtype": "float32",
             "ssm": {"d_state": 16, "head_dim": 16, "d_conv": 4, "expand": 2, "chunk": 32}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips with a reason where there is none")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root, folder, bench) of the copy with the throwaway cells ``tiny.score``
    and ``tiny.train_ckpt`` and the metric ``tokens_in_window``."""
    root = tmp_path_factory.mktemp("bench")
    folder = root / "perfbench"
    shutil.copytree(harness.FOLDER, folder, ignore=shutil.ignore_patterns("__pycache__", "test_*", "conftest.py"))
    bench = json.loads((harness.FOLDER.parent / "BENCHMARK.json").read_text())
    base = bench["configs"][0]
    config = json.loads((harness.FOLDER.parent / base["file"]).read_text())
    config.update(TINY, name="tiny")
    config["mamba2_layer"] = {**config["mamba2_layer"], **TINY_LAYER}
    config["port"] = {**config["port"], **TINY_PORT, "name": "tiny"}
    (folder / "configs" / "tiny.json").write_text(json.dumps(config))
    bench["configs"].append({**base, "name": "tiny", "file": "perfbench/configs/tiny.json"})
    for traffic in ("score", "train_ckpt"):
        mix = json.loads((folder / "traffic" / f"{traffic}.json").read_text())
        mix.update(batch=2, seq=64, pool_batches=4)
        (folder / "traffic" / f"tiny_{traffic}.json").write_text(json.dumps(mix))
        real = f"{base['name']}.{traffic}"  # a held cell keeps its files without an entry
        shutil.copy(folder / "limits" / f"{real}.json", folder / "limits" / f"tiny.{traffic}.json")
        bench["workloads"].append({"name": f"tiny.{traffic}", "config": "tiny", "traffic": f"tiny_{traffic}",
                                   "chips": 1, "why": "a throwaway cell at a tiny size"})
        for entry in bench["end_to_end"] + bench["per_layer"]:
            if real in entry.get("workloads", ()):
                entry["workloads"].append(f"tiny.{traffic}")
    (folder / "metrics" / "tokens_in_window.py").write_text(
        "def read(run):\n    return float(run['tokens'])\n")
    bench["per_layer"].append({"name": "tokens_in_window", "unit": "tokens", "better": "higher",
                               "source": "host_clock", "layer": "perfbench driver",
                               "moves": "score_tokens_per_s", "workloads": ["tiny.score"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, folder, bench


@pytest.fixture
def run_tiny(tiny):
    """One run of a throwaway cell on the CPU -> (cell, outcome)."""
    root, folder, bench = tiny

    def run(workload: str, seed: int = 2147483659, seconds: float = 0.5, trace: bool = False):
        cell = harness.make_cell(bench, root, workload, seed, seconds, trace, folder=folder, device="cpu")
        return cell, harness.load_module("drivers", cell.mix["driver"], folder).run(cell)
    return run
