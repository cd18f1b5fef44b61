"""The cells driven on the CPU at a tiny size: a throwaway cell added from a
temporary directory, the plain reference against the port, and each fault
of the timed path seen by the check that decides ``correct``."""

import filecmp
import math

import numpy as np
import pytest
import torch

from perfbench import faults, harness, weights
from perfbench.drivers import train as train_driver


def test_a_cell_is_added_by_new_files_and_entries_alone(tiny, run_tiny):
    root, folder, bench = tiny
    for path in harness.FOLDER.rglob("*"):
        rel = path.relative_to(harness.FOLDER)
        if path.is_file() and "__pycache__" not in rel.parts and not path.name.startswith(("test_", "conftest")):
            assert filecmp.cmp(path, folder / rel, shallow=False), rel
    cell, out = run_tiny("tiny.score")
    cell.trace = True  # the per-layer metrics of the run, as a traced run reports them
    line = harness.result(bench, cell, out, {"platform": "cpu"})
    assert line["correct"] is True
    assert line["metrics"]["tokens_in_window"]["value"] == out.readings["tokens"] > 0
    assert "ssd_scan_roofline" not in line["metrics"]  # no device trace to read: left out, never 0
    cell.trace = False
    line0 = harness.result(bench, cell, out, {"platform": "cpu"})
    assert set(line0["metrics"]) == {"score_tokens_per_s", "setup_s"}
    assert list(line0["checks"]) == list(cell.limits["checks"])


def test_the_reference_agrees_with_the_port(tiny):
    from repro_torch import models

    root, folder, bench = tiny
    cell = harness.make_cell(bench, root, "tiny.score", 7, 1.0, False, folder=folder, device="cpu")
    ref = harness.load_module("reference", "ssm", folder)
    shapes = ref.param_shapes(cell.config)
    w = weights.make(shapes, 7, "cpu", torch.float32)
    tokens = torch.randint(1, 255, (2, 64), generator=torch.Generator().manual_seed(0))
    targets = torch.roll(tokens, -1, 1)
    targets[:, -1] = -1
    port, _ = models.train_loss(models.ModelParams.from_tree(w), harness.port_config(cell),
                                {"tokens": tokens, "targets": targets})
    assert ref.loss(w, cell.config, tokens, targets) == pytest.approx(float(port), abs=1e-5)
    assert abs(ref.loss(w, cell.config, tokens, targets, quant="fp8") - float(port)) > 1e-4


def test_the_same_seed_makes_the_same_weights_and_another_seed_others():
    shapes = {"a": ((3, 64), "normal", 0.5), "b": [{"c": ((5,), "a_log", (1, 16)), "d": ((4,), "ones", None),
                                                     "e": ((300,), "dt_bias", (0.001, 0.1, 1e-4))}]}
    a, b = weights.make(shapes, 2**31 + 5, "cpu", torch.bfloat16), weights.make(shapes, 2**31 + 5, "cpu",
                                                                                    torch.bfloat16)
    c = weights.make(shapes, 2**31 + 6, "cpu", torch.bfloat16)
    assert torch.equal(a["a"], b["a"]) and torch.equal(a["b"][0]["c"], b["b"][0]["c"])
    assert not torch.equal(a["a"], c["a"])
    assert a["a"].dtype == torch.bfloat16 and a["b"][0]["c"].dtype == torch.float32
    assert torch.all(a["b"][0]["d"] == 1) and float(a["a"].float().std()) == pytest.approx(0.5, rel=0.3)
    assert torch.all((a["b"][0]["c"] >= 0) & (a["b"][0]["c"] < math.log(16)))
    dt = torch.nn.functional.softplus(a["b"][0]["e"].float())
    assert float(dt.min()) > 0.0009 and float(dt.max()) < 0.11


@pytest.mark.parametrize("workload", ["tiny.score", "tiny.train_ckpt"])
def test_a_sound_run_is_correct(run_tiny, workload):
    cell, out = run_tiny(workload)
    ok, table = harness.judge(out.checks, cell.limits)
    assert ok, table
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("driver, fault", [(d, f) for d, fs in faults.BY_DRIVER.items() for f in fs])
def test_each_fault_makes_the_run_incorrect(run_tiny, driver, fault):
    workload = {"score": "tiny.score", "train": "tiny.train_ckpt"}[driver]
    with faults.planted(fault, driver):
        cell, out = run_tiny(workload)
    ok, table = harness.judge(out.checks, cell.limits)
    assert not ok, table


def test_a_state_left_unchanged_reads_one():
    ref = {"losses": [1.0], "first_grad": {"a": 2.0, "b": 1.0}, "change": {"a": 3.0, "b": 0.5}}
    prog = {"losses": [1.0], "first_grad": {"a": 0.0, "b": 0.0}, "change": {"a": 0.0, "b": 0.0}}
    got = train_driver.compare(prog, ref)
    assert got["change_gap"] == 1.0 and got["grad_gap"] == 1.0
    assert train_driver.compare(ref, ref) == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_fingerprint_sees_one_flipped_bit():
    state = {"a": torch.randn(64, dtype=torch.bfloat16), "b": [torch.randn(3, 3), torch.tensor(7, dtype=torch.int32)]}
    before = train_driver.fingerprint(state)
    state["a"].view(torch.int16)[5] ^= 1
    after = train_driver.fingerprint(state)
    assert int((before != after).sum()) == 1 and not math.isnan(float(before.sum()))


def test_fingerprint_sees_two_elements_swapped():
    state = {"a": torch.randn(1000, dtype=torch.bfloat16), "b": torch.randn(40, 25)}
    before = train_driver.fingerprint(state)
    state["a"][[17, 901]] = state["a"][[901, 17]].clone()
    state["b"][[0, 39]] = state["b"][[39, 0]].clone()
    after = train_driver.fingerprint(state)
    assert int((before != after).sum()) == 2
    assert torch.equal(train_driver.fingerprint({k: v.clone() for k, v in state.items()}), after)


def test_the_traffic_draws_its_law_from_the_seed():
    from perfbench.traffic import TokenStream

    mix = {"batch": 16, "seq": 2048, "tokens": {"distribution": "zipf_mandelbrot", "exponent": 1.0,
                                                "offset": 2.7, "stream": 1}}
    a, b = TokenStream(mix, 50277, 2**31 + 11), TokenStream(mix, 50277, 2**31 + 12)
    x = a.batch_for_step(3)
    assert np.array_equal(x["tokens"], a.batch_for_step(3)["tokens"])
    assert not np.array_equal(x["tokens"], b.batch_for_step(3)["tokens"])
    assert not np.array_equal(x["tokens"], a.batch_for_step(4)["tokens"])
    assert np.array_equal(x["tokens"][:, 1:], x["targets"][:, :-1]) and x["tokens"].dtype == np.int32
    toks = np.concatenate([a.batch_for_step(i)["tokens"].ravel() for i in range(8)])
    assert 0 <= toks.min() and toks.max() < 50277
    assert float(a.cdf[0]) == pytest.approx(0.02798, abs=1e-4)  # the commonest id's share
    assert float(np.mean(toks == 0)) == pytest.approx(float(a.cdf[0]), rel=0.05)
    with pytest.raises(ValueError, match="unknown token distribution"):
        TokenStream({**mix, "tokens": {**mix["tokens"], "distribution": "zipf"}}, 50277, 1)
