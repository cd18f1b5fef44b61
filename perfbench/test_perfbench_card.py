"""On the card, at each cell's own size: the program passes its check on a
fresh seed, and the control (the reference in float8 in the program's place)
fails it.  Each case is marked ``cuda`` and skips where there is no card:

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/
"""

import pytest
import torch

from perfbench import harness
from perfbench.drivers import score as score_driver
from perfbench.drivers import train as train_driver

pytestmark = pytest.mark.cuda
ROOT = harness.FOLDER.parent
SEED = 2147483693


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels at full width")
    torch.cuda.set_device(0)
    yield
    torch.cuda.empty_cache()


def cell_of(traffic: str) -> harness.Cell:
    """mamba2-370m under the mix; a held cell, whose files are there but not
    its entry in BENCHMARK.json, gets an entry here."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    workload = f"mamba2-370m.{traffic}"
    if all(w["name"] != workload for w in bench["workloads"]):
        bench["workloads"].append({"name": workload, "config": "mamba2-370m", "traffic": traffic, "chips": 1})
    return harness.make_cell(bench, ROOT, workload, SEED, 1.0, False)


def test_score_program_passes_and_control_fails(card):
    cell = cell_of("score")
    cfg, params, ref, shapes, pool = score_driver.build(cell)
    picked = list(range(cell.mix["check_batches"]))
    losses = [score_driver.score(params, cfg, pool, i, cell.device) for i in picked]
    del params
    expected = score_driver.reference_losses(cell, ref, shapes, pool, picked)
    control = score_driver.reference_losses(cell, ref, shapes, pool, picked, quant="fp8")
    limit = cell.limits["checks"]["loss_gap"]["limit"]
    assert max(abs(a - b) for a, b in zip(losses, expected)) <= limit
    assert max(abs(a - b) for a, b in zip(control, expected)) > limit


def test_train_program_passes_and_control_fails(card):
    cell = cell_of("train_ckpt")
    job = train_driver.Job(cell)
    try:
        job.load_weights(SEED)
        prog = job.first_steps(SEED)
        job.free_state()
        ref = job.reference(SEED)
        control = job.reference(SEED, quant="fp8")
    finally:
        job.close()
    ok, table = harness.judge({**train_driver.compare(prog, ref), "ckpt_mismatch": 0.0, "nonfinite_losses": 0.0},
                              cell.limits)
    assert ok, table
    bad, table = harness.judge({**train_driver.compare(control, ref), "ckpt_mismatch": 0.0,
                                "nonfinite_losses": 0.0}, cell.limits)
    assert not bad, table
