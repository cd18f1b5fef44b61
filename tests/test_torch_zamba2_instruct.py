"""The published Zamba2 (``zamba2-7b-instruct``) on the CPU, at ``reduced()``
and in float32: grouped B and C through the SSD scan's plain paths, the
softmax scale of ``gqa_attention``, the shared blocks' alternation counted
at the published site list, the gated-GELU MLP and its adapters, and the
refusal of prefill and decode.  The plain reference of ``perfbench/`` holds
the whole model (``perfbench/test_perfbench_hybrid.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_sequential_ref  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.ops import gqa_attention  # noqa: E402

PUBLISHED_SITES = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def tiny(**over):
    return reduced(get_config("zamba2-7b-instruct"), **over)


def batch(cfg, b=2, s=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g)
    targets = torch.roll(tokens, -1, 1)
    targets[:, -1] = -1
    return {"tokens": tokens, "targets": targets}


def test_the_published_config():
    cfg = ARCHS["zamba2-7b-instruct"]
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm.ngroups) == (81, 3584, 7168, 112, 2)
    assert cfg.hybrid_sites == PUBLISHED_SITES and cfg.n_shared_blocks == 2 and cfg.adapter_rank == 128
    assert cfg.resolved_head_dim == 224 and cfg.attn_scale == pytest.approx(112 ** -0.5)
    assert cfg.tie_embeddings and cfg.padded_vocab == 32000 and cfg.ffn_act == "gelu"
    # 7.36 B parameters: mixers 6.35 B, shared blocks 0.67 B, adapters and site linears 0.22 B
    held = sum(t.numel() for t in models.abstract_params(cfg).parameters())
    assert held == pytest.approx(7.36e9, rel=1e-3)
    # the analytic count leaves the biases and some norms out, as the reference's does
    assert cfg.param_count() == pytest.approx(held, rel=2e-4)
    # every other config keeps the reference's defaults
    for name, other in ARCHS.items():
        if name != "zamba2-7b-instruct":
            assert not other.published_hybrid and other.ssm.ngroups == 1 and other.attn_scale == 0.0


def test_reduced_keeps_every_option_at_a_tiny_size():
    cfg = tiny()
    assert cfg.ssm.ngroups == 2 and cfg.n_shared_blocks == 2 and cfg.adapter_rank > 0
    blocks = {s % cfg.n_shared_blocks for s in range(len(cfg.hybrid_sites))}
    assert blocks == {0, 1} and max(cfg.hybrid_sites) < cfg.n_layers
    assert cfg.attn_scale == pytest.approx((cfg.resolved_head_dim / 2) ** -0.5)
    held = sum(t.numel() for t in models.init_params(cfg, torch.Generator().manual_seed(0)).parameters())
    assert cfg.param_count() == pytest.approx(held, rel=0.05)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_scan_plain_paths_agree(groups):
    rng = np.random.default_rng(groups)
    b, s, h, p, n = 2, 64, 8, 16, 8
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32))
    a = -torch.from_numpy(rng.uniform(1, 4, h).astype(np.float32))
    bb = torch.from_numpy(rng.standard_normal((b, s, groups, n), dtype=np.float32))
    cc = torch.from_numpy(rng.standard_normal((b, s, groups, n), dtype=np.float32))
    d = torch.ones(h)
    chunked = tssm.ssd_chunked(x, dt, a, bb, cc, d, chunk=16)
    scan = ssd_ops.ssd_scan(x, dt, a, bb, cc, d, chunk=16)  # the kernel's plain version on the CPU
    # the direct recurrence, group by group: heads [g h/G, (g+1) h/G) read group g
    hg = h // groups
    want = torch.cat([ssd_sequential_ref(x[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg],
                                         a[i * hg:(i + 1) * hg], bb[:, :, i], cc[:, :, i],
                                         d[i * hg:(i + 1) * hg]) for i in range(groups)], dim=2)
    torch.testing.assert_close(chunked, want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(scan, want, atol=2e-4, rtol=2e-4)
    if groups == 1:  # a group of one is the ungrouped scan
        torch.testing.assert_close(chunked, tssm.ssd_chunked(x, dt, a, bb[:, :, 0], cc[:, :, 0], d, chunk=16))
    else:  # each head reads its own group: another mapping gives another answer
        swapped = tssm.ssd_chunked(x, dt, a, bb.flip(2), cc.flip(2), d, chunk=16)
        assert (swapped - want).abs().max() > 1e-2


def test_grouped_scan_keeps_the_state():
    rng = np.random.default_rng(5)
    b, s, h, p, n, g = 1, 32, 4, 8, 4, 2
    x = torch.from_numpy(rng.standard_normal((b, s, h, p), dtype=np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32))
    a = -torch.ones(h)
    bb, cc = (torch.from_numpy(rng.standard_normal((b, s, g, n), dtype=np.float32)) for _ in range(2))
    y, state = tssm.ssd_chunked(x, dt, a, bb, cc, torch.zeros(h), chunk=8, return_state=True)
    _, s0 = tssm.ssd_chunked(x[:, :, :2], dt[:, :, :2], a[:2], bb[:, :, 0], cc[:, :, 0], torch.zeros(2),
                             chunk=8, return_state=True)
    assert state.shape == (b, h, p, n)
    torch.testing.assert_close(state[:, :2], s0)


def test_gated_norm_normalises_each_group():
    rng = np.random.default_rng(1)
    y, z = (torch.from_numpy(rng.standard_normal((2, 3, 12), dtype=np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 12).astype(np.float32))
    got = tssm.rms_norm(y, w, 1e-5, z=z, groups=3)  # the mixer's plain gated norm
    g = (y * torch.nn.functional.silu(z)).reshape(2, 3, 3, 4)
    want = (g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + 1e-5)).reshape(2, 3, 12) * w
    torch.testing.assert_close(got, want)
    one = tssm.rms_norm(y, w, 1e-5, z=z)
    assert (one - got).abs().max() > 1e-2  # over the whole width it is another norm


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_attention_takes_a_softmax_scale(impl):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 32), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 32), dtype=np.float32)) for _ in range(2))
    default = gqa_attention(q, k, v, causal=True, impl=impl, chunk=16)
    same = gqa_attention(q, k, v, causal=True, impl=impl, chunk=16, scale=32 ** -0.5)
    torch.testing.assert_close(same, default)
    # a scale s is the default scale of q * s * sqrt(d)
    scaled = gqa_attention(q, k, v, causal=True, impl=impl, chunk=16, scale=16 ** -0.5)
    torch.testing.assert_close(scaled, gqa_attention(q * (16 ** -0.5 * 32 ** 0.5), k, v, causal=True,
                                                     impl=impl, chunk=16), atol=1e-5, rtol=1e-5)
    assert (scaled - default).abs().max() > 1e-2
    naive = gqa_attention(q, k, v, causal=True, impl="naive", scale=16 ** -0.5)
    torch.testing.assert_close(scaled, naive, atol=1e-5, rtol=1e-5)


def test_the_attention_op_carries_the_scale_on_meta_tensors():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as fa_ops

    q = torch.empty((1, 64, 2, 1, 224), device="meta")
    k = torch.empty((1, 64, 2, 224), device="meta")
    with FlopCounterMode(display=False) as counter:
        out = fa_ops.flash_attention(q, k, k, causal=True, scale=112 ** -0.5)
    assert out.shape == q.shape and out.device.type == "meta"
    assert counter.get_total_flops() == 4 * 224 * (64 * 65 // 2) * 2


def test_shared_blocks_alternate_at_the_published_sites():
    cfg = tiny(n_layers=81, hybrid_sites=PUBLISHED_SITES)
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    tmodel.reset_shared_block_calls()
    with torch.no_grad():
        loss, _ = models.train_loss(params, cfg, batch(cfg, b=1, s=32))
    assert torch.isfinite(loss)
    assert tmodel.SHARED_BLOCK_CALLS == {0: 7, 1: 6}
    tmodel.reset_shared_block_calls()
    assert tmodel.SHARED_BLOCK_CALLS == {}


def test_the_site_output_feeds_the_mixer_input_only():
    # with every mixer's output projection zero the residual stream is the
    # embedding throughout: the shared blocks reach the loss only through a mixer
    cfg = tiny()
    params = models.init_params(cfg, torch.Generator().manual_seed(1))
    b = batch(cfg)
    with torch.no_grad():
        for bp in params.blocks:
            bp.out_proj.zero_()
        h, _ = models.forward_hidden(params, cfg, b["tokens"])
        x0 = params.embed[b["tokens"]]
        want = models.model.rms_norm(x0, params.final_norm, cfg.norm_eps)
    torch.testing.assert_close(h, want)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_each_option_moves_the_loss(impl):
    cfg = dataclasses.replace(tiny(), attn_impl=impl)
    params = models.init_params(cfg, torch.Generator().manual_seed(3))
    b = batch(cfg, seed=3)

    def loss(c=cfg, p=params):
        with torch.no_grad():
            return float(models.train_loss(p, c, b)[0])
    base = loss()
    moved = {"attn_scale": loss(dataclasses.replace(cfg, attn_scale=0.0)),
             "ffn_act": loss(dataclasses.replace(cfg, ffn_act="silu"))}
    swapped = models.init_params(cfg, torch.Generator().manual_seed(3))
    with torch.no_grad():  # heads read the other group's B and C
        for bp in swapped.blocks:
            for name in ("w_B", "w_C", "conv_B", "conv_C", "conv_B_b", "conv_C_b"):
                t = bp[name]
                t.copy_(torch.cat(t.chunk(2, dim=-1)[::-1], dim=-1))
    moved["groups"] = loss(p=swapped)
    with torch.no_grad():
        for site in params.sites:
            site.lora_in.zero_()
    moved["adapter"] = loss()
    assert all(abs(v - base) > 1e-4 for v in moved.values()), (base, moved)


def test_prefill_and_decode_refuse_the_published_options():
    cfg = tiny()
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    cache = models.init_cache(cfg, 1, 16)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for call in (lambda: models.prefill(params, cfg, tokens, cache),
                 lambda: models.decode_step(params, cfg, tokens[:, :1], cache)):
        with pytest.raises(ValueError, match="hybrid_sites.*n_shared_blocks.*adapter_rank"):
            call()
    one = dataclasses.replace(get_config("zamba2-7b"), ssm=dataclasses.replace(get_config("zamba2-7b").ssm,
                                                                               ngroups=2))
    with pytest.raises(ValueError, match=r"\['ssm.ngroups'\]"):
        models.model._refuse_published_hybrid(one, "prefill")
    models.model._refuse_published_hybrid(get_config("zamba2-7b"), "prefill")  # the reference's hybrid runs


def test_the_tree_round_trips():
    cfg = tiny()
    params = models.init_params(cfg, torch.Generator().manual_seed(4))
    tree = params.tree()
    assert isinstance(tree["shared"], list) and len(tree["shared"]) == 2 and len(tree["sites"]) == 3
    again = models.ModelParams.from_tree(tree)
    other = models.init_params(cfg, torch.Generator().manual_seed(5))
    other.copy_from(tree)
    for a, b in zip(again.parameters(), other.parameters()):
        assert torch.equal(a, b)
    assert sorted(models.logical_axes(cfg)) == sorted(tree)


SHARED_STAGES = ("shared.attn_in", "shared.attn", "shared.attn_out", "shared.mlp", "shared.linear")


def test_the_shared_blocks_run_as_flat_stages_once_a_site():
    from torch.profiler import ProfilerActivity, profile

    cfg = tiny()
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain, _ = models.train_loss(params, cfg, batch(cfg))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced, _ = models.train_loss(params, cfg, batch(cfg))
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.is_user_annotation())
    names = [name for _, _, name in ranges]
    assert torch.equal(plain, traced)
    assert all(end <= nxt for (_, end, _), (nxt, _, _) in zip(ranges, ranges[1:]))
    assert [n for n in names if n.startswith("shared.")] == list(SHARED_STAGES) * len(cfg.hybrid_sites)
    # a site's stages run between the previous layer's mixer and its own
    first = names.index("shared.attn_in")
    assert names[first - 1] == "ssm.out_proj" and names[first + 5] == "ssm.norm_in"


def test_the_stage_tool_gives_the_shared_blocks_a_share():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "score_stages", Path(__file__).resolve().parents[1] / "tools" / "score_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    table = {"ssm.scan": {"s": 5.0, "kernels": {}}, "shared.attn": {"s": 1.0, "kernels": {}},
             "shared.mlp": {"s": 3.0, "kernels": {}}, "shared.linear": {"s": 1.0, "kernels": {}}}
    got = tool.shares(table)
    assert got["shared"] == pytest.approx(50.0) and got["scan_glue"] == pytest.approx(50.0)
    assert "shared" not in tool.shares({"ssm.scan": {"s": 1.0, "kernels": {}}})
