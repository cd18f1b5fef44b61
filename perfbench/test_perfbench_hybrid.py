"""The hybrid cell's parts on the CPU at a tiny size: the plain Zamba2
reference (``reference/hybrid.py``) against the port, each departure of one
side from the published block seen by that comparison, the parameter layout
at the published widths, the flop count of ``roofline_hybrid.py`` against a
hand count and against ``torch.utils.flop_counter``'s count of the port's
products, and the two readers the cell adds."""

import ast
import dataclasses
import json
from unittest import mock

import pytest
import torch

from perfbench import harness, roofline, roofline_hybrid, weights

ROOT = harness.FOLDER.parent
CONFIG = json.loads((harness.FOLDER / "configs" / "zamba2-7b-instruct.json").read_text())
#: the published names at a tiny size: five layers, sites 1, 3 and 4 (blocks A, B, A),
#: two groups, rank-8 adapters, heads of 32 over concat(h, x0); float32
TINY = {"hidden_size": 64, "num_hidden_layers": 5, "n_mamba_heads": 8, "mamba_headdim": 16,
        "mamba_d_state": 16, "chunk_size": 32, "attention_hidden_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 4, "attention_head_dim": 32, "kv_channels": 16, "ffn_hidden_size": 128,
        "intermediate_size": 128, "adapter_rank": 8, "hybrid_layer_ids": [1, 3, 4], "vocab_size": 256,
        "pad_vocab_size_multiple": 8, "dtype": "float32"}
TINY_PORT = {"n_layers": 5, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 32, "d_ff": 128,
             "vocab": 256, "pad_vocab_multiple": 8, "dtype": "float32", "hybrid_sites": [1, 3, 4],
             "adapter_rank": 8, "attn_scale": 16 ** -0.5,
             "ssm": {"d_state": 16, "head_dim": 16, "d_conv": 4, "expand": 2, "chunk": 32, "ngroups": 2}}
#: float32 on both sides, in different orders of operations over five layers:
#: the losses (about 5.5) agree to a few float32 ulps of the sums
TOL = 2e-5


def tiny_config() -> dict:
    config = {**CONFIG, **TINY, "name": "tiny-hybrid"}
    config["port"] = {**CONFIG["port"], **TINY_PORT, "name": "tiny-hybrid"}
    return config


def port_config(config: dict, impl: str):
    mix = {"port": {"attn_impl": impl}}
    return harness.port_config(harness.Cell("tiny", {}, config, mix, {}, 0, 0.0, False))


def reference():
    return harness.load_module("reference", "hybrid")


def inputs(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, 256, (2, 64), generator=g)
    targets = torch.roll(tokens, -1, 1)
    targets[:, -1] = -1
    return tokens, targets


def port_loss(w: dict, config: dict, impl: str, tokens, targets) -> float:
    from repro_torch import models

    with torch.no_grad():
        loss, _ = models.train_loss(models.ModelParams.from_tree(w), port_config(config, impl),
                                    {"tokens": tokens, "targets": targets})
    return float(loss)


@pytest.fixture(scope="module")
def tiny():
    config = tiny_config()
    w = weights.make(reference().param_shapes(config), 2147483659, "cpu", torch.float32)
    tokens, targets = inputs()
    return config, w, tokens, targets, reference().loss(w, config, tokens, targets)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_the_reference_agrees_with_the_port(tiny, impl):
    config, w, tokens, targets, ref_loss = tiny
    assert port_loss(w, config, impl, tokens, targets) == pytest.approx(ref_loss, abs=TOL)
    assert abs(reference().loss(w, config, tokens, targets, quant="fp8") - ref_loss) > TOL


def _swap_groups(w: dict) -> dict:
    """Heads read the other group's B and C: each layer's B and C halves swapped."""
    def swap(t):
        return torch.cat(t.chunk(2, dim=-1)[::-1], dim=-1)
    blocks = [{k: swap(v) if k in ("w_B", "w_C", "conv_B", "conv_C", "conv_B_b", "conv_C_b") else v
               for k, v in layer.items()} for layer in w["blocks"]]
    return {**w, "blocks": blocks}


def _departures():
    """name -> (what the port is given in place of the weights, a patch of the
    reference): each departs from the published block on one side alone."""
    ref = reference()

    def residual_site(weights_, cfg, tokens, quant=None):  # the site's output into the residual
        eps, x0 = cfg["rms_norm_eps"], weights_["embed"][tokens.long()]
        h, site_of = x0, {layer: s for s, layer in enumerate(cfg["hybrid_layer_ids"])}
        for layer, w in enumerate(weights_["blocks"]):
            if layer in site_of:
                s = site_of[layer]
                h = h + ref.shared_block(h, x0, weights_["shared"][s % 2], weights_["sites"][s], cfg, quant)
            h = h + ref.mixer(ref.rms_norm(h, w["norm_in"], eps), w, cfg, quant)
        return ref.rms_norm(h, weights_["final_norm"], eps)

    def one_norm(y, z, w, groups, eps):  # the gate norm over the whole width
        g = y * torch.nn.functional.silu(z)
        return g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps) * w

    return {
        "adapter left out": (lambda w: {**w, "sites": [{**s, "lora_in": torch.zeros_like(s["lora_in"])}
                                                        for s in w["sites"]]}, None),
        "one shared block for two": (lambda w: {**w, "shared": [w["shared"][0]] * 2}, None),
        "224^-0.5 for 112^-0.5": (None, ("softmax_scale", lambda cfg: cfg["attention_head_dim"] ** -0.5)),
        "site output into the residual": (None, ("hidden", residual_site)),
        "ungrouped gate norm": (None, ("gated_rms_norm", one_norm)),
        "heads mapped to the wrong group": (_swap_groups, None),
    }


@pytest.mark.parametrize("name", list(_departures()))
def test_each_departure_moves_the_loss_past_the_tolerance(tiny, name):
    config, w, tokens, targets, ref_loss = tiny
    give, patch = _departures()[name]
    if give is not None:  # the port departs
        assert abs(port_loss(give(w), config, "naive", tokens, targets) - ref_loss) > 5 * TOL
    else:  # the reference departs
        ref = reference()
        with mock.patch.object(ref, patch[0], patch[1]):
            moved = ref.loss(w, config, tokens, targets)
        assert abs(moved - port_loss(w, config, "naive", tokens, targets)) > 5 * TOL


def test_the_layout_holds_at_the_published_widths():
    from repro_torch import models
    from repro_torch.configs import get_config

    shapes = reference().param_shapes(CONFIG)
    cfg = port_config(CONFIG, "pallas")
    assert cfg == dataclasses.replace(get_config("zamba2-7b-instruct"), attn_impl="pallas")
    harness.check_layout(shapes, models.abstract_params(cfg).tree())
    with pytest.raises(ValueError, match="sites"):
        harness.check_layout({**shapes, "sites": shapes["sites"][:12]}, models.abstract_params(cfg).tree())


def test_the_reference_imports_nothing_of_the_program_or_of_jax():
    tree = ast.parse((harness.FOLDER / "reference" / "hybrid.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "math", "torch", "torch.nn.functional", "perfbench.reference.ssm"}


def test_the_configuration_holds_the_catalog_entry():
    assert CONFIG["source"] == "https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json"
    assert (CONFIG["hidden_size"], CONFIG["num_hidden_layers"], CONFIG["mamba_ngroups"],
            CONFIG["attention_head_dim"], CONFIG["adapter_rank"], CONFIG["num_mem_blocks"]) == (
        3584, 81, 2, 224, 128, 2)
    kinds = [t for t in CONFIG["layers_block_type"]]
    assert [i for i, t in enumerate(kinds) if t == "hybrid"] == CONFIG["hybrid_layer_ids"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "zamba2-7b-instruct")
    assert entry["reduced"] == [] and entry["file"] == "perfbench/configs/zamba2-7b-instruct.json"


def test_the_flop_count_by_hand_at_a_tiny_size():
    c = tiny_config()
    parts = roofline_hybrid.forward_flops(c, 64)
    dm, di, gn, h = 64, 128, 32, 8
    assert parts["mixer_proj"] == 5 * 2 * (dm * (2 * di + 2 * gn + h) + di * dm)
    assert parts["conv"] == 5 * 2 * 4 * (di + 2 * gn)
    assert parts["scan"] == 5 * roofline.ssd_ops(8, 64, 16, 16, 32, 2) / 64
    shared = 128 * 128 * 3 + 128 * 64 + 3 * 64 * 128 + 8 * (64 + 256) + 64 * 64
    assert parts["shared_proj"] == 3 * 2 * shared
    assert parts["attention"] == 3 * 4 * 32 * 4 * (64 * 65 // 2) / 64
    assert parts["head"] == 2 * 64 * 256
    assert roofline_hybrid.forward_flops_per_token(c, 64) == pytest.approx(sum(parts.values()))


def test_the_published_flop_count():
    parts = roofline_hybrid.forward_flops(CONFIG, 4096)
    total = roofline_hybrid.forward_flops_per_token(CONFIG, 4096)
    assert total == pytest.approx(23.1e9, rel=0.01)
    assert parts["mixer_proj"] == pytest.approx(12.7e9, rel=0.01)
    assert parts["shared_proj"] == pytest.approx(9.1e9, rel=0.01)
    assert parts["attention"] == pytest.approx(0.763e9, rel=0.01)


def test_the_projection_count_equals_the_flop_counter_on_the_port():
    """The port's products in one forward (on the meta device, K3's op counted
    by its registered formula; the scan and the convolution, which the count
    takes from their own formulas, stubbed out) against the count."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import models
    from repro_torch.kernels.causal_conv import ops as conv_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    config = tiny_config()
    cfg = port_config(config, "pallas")
    params = models.abstract_params(cfg)
    tokens = torch.zeros((2, 64), dtype=torch.long, device="meta")
    with mock.patch.object(ssd_ops, "ssd_scan", lambda x, *a, **k: torch.empty_like(x)), \
            mock.patch.object(conv_ops, "causal_conv1d", lambda x, w, b: torch.empty_like(x)), \
            FlopCounterMode(display=False) as counter, torch.no_grad():
        models.train_loss(params, cfg, {"tokens": tokens, "targets": tokens})
    by_op = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    attention = sum(n for op, n in by_op.items() if "flash_attention" in op)
    products = counter.get_total_flops() - attention
    parts = roofline_hybrid.forward_flops(config, 64)
    tokens_n = 2 * 64
    assert attention == parts["attention"] * tokens_n
    assert products == (parts["mixer_proj"] + parts["shared_proj"] + parts["head"]) * tokens_n


def test_the_readers_of_the_cell():
    mfu = harness.load_module("metrics", "mfu.score_4k")
    flash = harness.load_module("metrics", "flash_attention_roofline")
    mix = {"batch": 16, "seq": 4096}
    run = {"config": CONFIG, "mix": mix, "window_s": 40.0, "tokens": 10 * 16 * 4096, "trace": None}
    want = 100 * roofline_hybrid.forward_flops_per_token(CONFIG, 4096) * run["tokens"] / 40.0 / roofline.BF16_PEAK
    assert mfu.read(run) == pytest.approx(want)
    assert flash.read(run) is None  # no trace: nothing to read
    bound, by = roofline.attention_bound(bh=16 * 32, bk=16 * 32, sq=4096, sk=4096, d=224, itemsize=2,
                                         causal=True)
    assert by == "operations" and bound * 1e3 == pytest.approx(3.9, rel=0.02)
    name = "void (anonymous namespace)::wg::flash_attention_wgmma<224>(CUtensorMap, ...)"
    trace = {"kernels": {name: (130 * bound / 0.5, 130), "ssd_chunk_scan<64>": (3.0, 810)}}
    assert flash.read({**run, "trace": trace}) == pytest.approx(50.0)
    # a cell without K3 has nothing for its roofline to read
    mamba = json.loads((harness.FOLDER / "configs" / "mamba2-370m.json").read_text())
    run2 = {**run, "config": mamba, "mix": {"batch": 256, "seq": 2048}}
    assert flash.read({**run2, "trace": {"kernels": {"ssd_chunk_scan<64>": (3.0, 810)}}}) is None
