"""The models' named stages (``repro_torch.obs.stages``) on the CPU.

Under ``torch.profiler`` the ssm forward of ``train_loss`` shows each stage
as a flat user range, the mixer's once per layer, and the loss is bit for
bit what it is without a profiler.  Outside a profile :func:`stage` returns
the tracer's one null span and allocates nothing inside ``repro_torch.obs``.
``tools/score_stages.py`` puts each of the card's operations under the stage
open at its launch, here on synthetic profiler events.
"""

import dataclasses
import importlib.util
import tracemalloc
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.models import init_params, train_loss  # noqa: E402
from repro_torch.obs import tracer  # noqa: E402
from repro_torch.obs.stages import stage  # noqa: E402

MODEL_STAGES = ("model.embed", "model.final_norm", "model.head_ce")
LAYER_STAGES = ("ssm.norm_in", "ssm.in_proj", "ssm.conv", "ssm.scan", "ssm.gate_norm", "ssm.out_proj")


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def tiny(**kw):
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")), n_layers=3, **kw)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    return cfg, params, batch


def profiled_loss(cfg, params, batch):
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = train_loss(params, cfg, batch)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.is_user_annotation())
    return loss, ranges


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_stages_cover_the_forward_flat_and_once_per_layer(impl):
    cfg, params, batch = tiny(attn_impl=impl)
    _, ranges = profiled_loss(cfg, params, batch)
    names = [name for _, _, name in ranges]
    assert set(names) == set(MODEL_STAGES) | set(LAYER_STAGES)
    for name in MODEL_STAGES:
        assert names.count(name) == 1, name
    for name in LAYER_STAGES:
        assert names.count(name) == cfg.n_layers, name
    # flat: each range ends before the next begins
    assert all(end <= nxt for (_, end, _), (nxt, _, _) in zip(ranges, ranges[1:]))
    # in the forward's order
    mixer = [n for n in names if n.startswith("ssm.")]
    assert mixer == list(LAYER_STAGES) * cfg.n_layers
    assert names[0] == "model.embed" and names[-2:] == ["model.final_norm", "model.head_ce"]


def test_loss_is_bit_equal_with_and_without_a_profiler():
    cfg, params, batch = tiny()
    with torch.no_grad():
        plain, _ = train_loss(params, cfg, batch)
    traced, _ = profiled_loss(cfg, params, batch)
    assert torch.equal(plain, traced)
    # and with gradients, through the remat'd layers
    params["embed"].requires_grad_(True)
    loss, _ = train_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, params["embed"])
    with profile(activities=[ProfilerActivity.CPU]):
        loss2, _ = train_loss(params, cfg, batch)
        grads2 = torch.autograd.grad(loss2, params["embed"])
    assert torch.equal(loss, loss2) and torch.equal(grads[0], grads2[0])


def test_a_stage_outside_a_profile_is_the_null_span_and_allocates_nothing():
    assert stage("ssm.scan") is tracer._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert stage("ssm.scan") is not tracer._NULL_SPAN
    assert stage("ssm.scan") is tracer._NULL_SPAN

    def hot():
        for _ in range(1000):
            with stage("ssm.conv"):
                pass

    hot()
    obs_filter = tracemalloc.Filter(True, "*/repro_torch/obs/*")
    tracemalloc.start(25)
    try:
        before = tracemalloc.take_snapshot().filter_traces([obs_filter])
        hot()
        after = tracemalloc.take_snapshot().filter_traces([obs_filter])
    finally:
        tracemalloc.stop()
    grew = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0 or d.count_diff > 0]
    assert not grew, f"obs allocations outside a profile: {grew}"


# tools/score_stages.py: card time by stage from the profiler's events


def score_stages_tool():
    spec = importlib.util.spec_from_file_location(
        "score_stages", Path(__file__).resolve().parents[1] / "tools" / "score_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


class Ev:
    """A stand-in for one of the profiler's kineto events."""

    def __init__(self, name, start, end, device="cpu", corr=0, linked=0, tid=1, annotation=False):
        from torch.autograd import DeviceType

        self._name, self._start, self._dur = name, start, end - start
        self._device = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
        self._corr, self._linked, self._tid, self._ann = corr, linked, tid, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._ann


MS = 1_000_000


def staged_events():
    """A forward whose host launches under two stages and outside them,
    traced over the host and the card: the stages' ranges on the host and
    their shadows on the card, the PyTorch calls, their runtime calls, and
    the card's operations."""
    ms = MS
    return [
        Ev("ssm.conv", 10 * ms, 20 * ms, annotation=True, corr=1),
        Ev("aten::conv1d", 11 * ms, 12 * ms, corr=2),
        Ev("cudaLaunchKernel", 11 * ms, 11 * ms + 10, corr=9001, linked=2),
        Ev("aten::add", 21 * ms, 22 * ms, corr=3),  # the residual add: under no stage
        Ev("cudaLaunchKernel", 21 * ms, 21 * ms + 10, corr=9002, linked=3),
        Ev("ssm.scan", 30 * ms, 60 * ms, annotation=True, corr=4),
        Ev("aten::copy_", 31 * ms, 32 * ms, corr=5),
        Ev("cudaLaunchKernel", 31 * ms, 31 * ms + 10, corr=9003, linked=5),
        Ev("_ForwardOnly", 33 * ms, 34 * ms, corr=6),
        Ev("cuLaunchKernelEx", 33 * ms, 33 * ms + 10, corr=9004, linked=6),
        # a thread that launches nothing, with a stage of its own
        Ev("ssm.conv", 0, 100 * ms, annotation=True, corr=7, tid=2),
        Ev("ssm.conv", 12 * ms, 20 * ms, device="cuda", annotation=True, corr=1),
        Ev("conv_depthwise2d_forward", 12 * ms, 20 * ms, device="cuda", corr=9001, linked=2),
        Ev("elementwise_kernel", 22 * ms, 25 * ms, device="cuda", corr=9002, linked=3),
        Ev("elementwise_kernel", 32 * ms, 40 * ms, device="cuda", corr=9003, linked=5),
        Ev("void ssd_chunk_scan<128>(CUtensorMap)", 40 * ms, 50 * ms, device="cuda", corr=9004, linked=6),
        Ev("aten::zero_", 55 * ms, 56 * ms, corr=8),
        Ev("cudaMemsetAsync", 55 * ms, 55 * ms + 10, corr=9005, linked=8),
        Ev("Memset (Device)", 58 * ms, 59 * ms, device="cuda", corr=9005, linked=8),
        # a copy whose runtime call the trace lost: under no stage
        Ev("Memcpy HtoD", 60 * ms, 61 * ms, device="cuda", corr=9006, linked=9),
    ]


def test_card_ops_keep_the_cards_operations_alone():
    tool = score_stages_tool()
    ops = tool.card_ops(staged_events())
    assert [o[0] for o in ops] == ["conv_depthwise2d_forward", "elementwise_kernel", "elementwise_kernel",
                                   "void ssd_chunk_scan<128>(CUtensorMap)", "Memset (Device)", "Memcpy HtoD"]
    assert [(a, b) for _, a, b, _ in ops] == [(12 * MS, 20 * MS), (22 * MS, 25 * MS), (32 * MS, 40 * MS),
                                             (40 * MS, 50 * MS), (58 * MS, 59 * MS), (60 * MS, 61 * MS)]


def test_each_operation_lands_under_the_stage_open_at_its_launch():
    tool = score_stages_tool()
    ops = tool.card_ops(staged_events())
    assert [o[3] for o in ops] == ["ssm.conv", tool.NO_STAGE, "ssm.scan", "ssm.scan", "ssm.scan", tool.NO_STAGE]
    table = tool.by_stage(ops)
    assert {k: v["s"] for k, v in table.items()} == {
        "ssm.conv": pytest.approx(0.008), tool.NO_STAGE: pytest.approx(0.004), "ssm.scan": pytest.approx(0.019)}
    assert sum(v["s"] for v in table.values()) == pytest.approx(sum((b - a) / 1e9 for _, a, b, _ in ops))
    assert table["ssm.scan"]["kernels"]["elementwise_kernel"] == pytest.approx(0.008)


def test_a_forward_without_stages_is_all_unstaged():
    tool = score_stages_tool()
    ops = tool.card_ops([e for e in staged_events() if not e.is_user_annotation()])
    assert {o[3] for o in ops} == {tool.NO_STAGE} and len(ops) == 6
    assert tool.shares(tool.by_stage(ops))["unstaged"] == pytest.approx(100.0)


def test_stage_group_shares():
    tool = score_stages_tool()
    table = {"ssm.conv": {"s": 2.0, "kernels": {}},
             "ssm.scan": {"s": 3.0, "kernels": {"void ssd_chunk_state<128>(CUtensorMap)": 0.5,
                                                "void ssd_chunk_scan<128>(CUtensorMap)": 1.5, "copy": 1.0}},
             "ssm.norm_in": {"s": 1.0, "kernels": {}}, "ssm.gate_norm": {"s": 0.5, "kernels": {}},
             "model.final_norm": {"s": 0.1, "kernels": {}}, "model.head_ce": {"s": 0.4, "kernels": {}},
             "ssm.in_proj": {"s": 2.0, "kernels": {}}, "ssm.out_proj": {"s": 0.6, "kernels": {}},
             tool.NO_STAGE: {"s": 0.4, "kernels": {}}}
    assert tool.shares(table) == {"conv": pytest.approx(20.0), "scan_glue": pytest.approx(10.0),
                                  "norm": pytest.approx(16.0), "head": pytest.approx(4.0),
                                  "unstaged": pytest.approx(4.0)}
