"""The device trace's reduction and the readers of it, on synthetic events."""

import pytest

from perfbench import harness, roofline, tracing

MS = 10**6  # nanoseconds


def events():
    # two overlapping kernels, a copy, a gap under "ckpt.save", one kernel half outside the window
    return [("ssd_chunk_state<128>", 10 * MS, 20 * MS), ("gemm", 15 * MS, 30 * MS),
            ("Memcpy DtoH", 40 * MS, 45 * MS), ("ssd_chunk_scan<128>", 95 * MS, 120 * MS)]


SPANS = [("step", 5 * MS, 32 * MS), ("ckpt.save", 32 * MS, 90 * MS), ("loss.read", 90 * MS, 100 * MS)]


def test_busy_is_the_union_inside_the_window():
    t = tracing.reduce_trace(events(), (0, 100 * MS), SPANS)
    assert t["window_s"] == pytest.approx(0.1)
    assert t["busy_s"] == pytest.approx((20 + 5 + 5) / 1e3)  # 10-30, 40-45, 95-100
    assert t["kernels"]["gemm"] == (pytest.approx(0.015), 1)
    assert t["kernels"]["ssd_chunk_scan<128>"][0] == pytest.approx(0.005)
    assert [name for name, _ in t["device_ops"]] == ["gemm", "ssd_chunk_state<128>", "Memcpy DtoH",
                                                     "ssd_chunk_scan<128>"]


def test_idle_gaps_are_named_by_the_covering_span():
    t = tracing.reduce_trace(events(), (0, 100 * MS), SPANS)
    gaps = dict(t["idle_gaps"])
    # 0-5 outside any span, 5-10 under step; 30-32 under step, 32-40 and 45-90 under ckpt.save;
    # 90-95 under loss.read
    assert gaps == {"outside spans": pytest.approx(0.005), "step": pytest.approx(0.007),
                    "ckpt.save": pytest.approx(0.053), "loss.read": pytest.approx(0.005)}
    assert t["busy_s"] + sum(gaps.values()) == pytest.approx(t["window_s"])


def test_spans_record_and_wrap():
    spans = tracing.Spans()
    f = spans.wrap("step", lambda x: x + 1)
    assert f(1) == 2
    with spans("loss.read"):
        pass
    assert [s[0] for s in spans.items] == ["step", "loss.read"]
    assert all(t1 >= t0 for _, t0, t1 in spans.items)


def readings(trace):
    config = harness.load_json(harness.FOLDER / "configs" / "mamba2-370m.json")
    mix = harness.load_json(harness.FOLDER / "traffic" / "score.json")
    return {"config": config, "mix": mix, "trace": trace, "window_s": 2.0, "tokens": 16384 * 10}


def test_idle_share_and_roofline_readers():
    cell = readings(None)
    bound, _ = roofline.ssd_bound(**roofline.ssd_shape(cell["config"], cell["mix"]["batch"], 2048), itemsize=2)
    # 48 calls, each launch pair taking four times the bound
    evs = []
    for i in range(48):
        t0 = i * 10 * MS
        evs += [("void ssd_chunk_state<128>(CUtensorMap)", t0, t0 + int(bound * 1e9)),
                ("void ssd_chunk_scan<128>(CUtensorMap)", t0 + int(bound * 1e9), t0 + int(4 * bound * 1e9))]
    trace = tracing.reduce_trace(evs, (0, 480 * MS), [])
    run = readings(trace)
    roof = harness.load_module("metrics", "ssd_scan_roofline").read(run)
    assert roof == pytest.approx(25.0, rel=1e-3)
    idle = harness.load_module("metrics", "idle_share.score").read(run)
    assert idle == pytest.approx(100 * (1 - 48 * 4 * bound / 0.48), rel=1e-3)
    mfu = harness.load_module("metrics", "mfu.score").read(run)
    assert mfu == pytest.approx(100 * roofline.forward_flops_per_token(run["config"], 2048) * 163840 / 2.0
                                / roofline.BF16_PEAK)


def test_readers_that_find_nothing_return_nothing():
    run = readings(tracing.reduce_trace([("gemm", 0, MS)], (0, 2 * MS), []))
    assert harness.load_module("metrics", "ssd_scan_roofline").read(run) is None
    for name in ("train_step_ms", "ckpt_stall_s", "ckpt_write_GiB_per_s"):
        assert harness.load_module("metrics", name).read(run) is None
    assert harness.load_module("metrics", "idle_share.train").read({"trace": None}) is None


def test_checkpoint_readers():
    saves = [{"bytes": 2**30, "snapshot_s": 2.0, "write_s": 4.0}, {"bytes": 2**30, "snapshot_s": 3.0, "write_s": 4.0}]
    run = {"saves": saves, "step_s": [1.5, 2.5]}
    assert harness.load_module("metrics", "ckpt_stall_s").read(run) == pytest.approx(2.5)
    assert harness.load_module("metrics", "ckpt_write_GiB_per_s").read(run) == pytest.approx(0.25)
    assert harness.load_module("metrics", "train_step_ms").read(run) == pytest.approx(2000.0)
