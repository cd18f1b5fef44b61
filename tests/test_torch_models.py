"""The port's model code on the CPU, against the JAX package.

``repro_torch.models.ops`` is held against ``repro.models.ops`` function by
function at 1e-5 in float32, and ``prefill`` plus four ``decode_step``s of
``reduced(qwen2.5-3b)`` against the reference's at 1e-4 in float32, with the
reference's parameters carried across by ``params_from_numpy``.  Inputs come
from a numpy seed.  ``attn_impl="pallas"`` runs the reference's Pallas
kernel in interpret mode and the port's plain flash version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ops as jops  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.distributed.sharding import constrain  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    init_cache,
    init_params,
    params_from_numpy,
    prefill,
)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ops as tops  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def both(*xs):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


def close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **(tol or F32))


def qwen(**over):
    return dataclasses.replace(reduced(get_config("qwen2.5-3b")), **over)


def jqwen(**over):
    return dataclasses.replace(jreduced(jget_config("qwen2.5-3b")), **over)


# ---------------------------------------------------------------------------
# models/ops.py
# ---------------------------------------------------------------------------

def test_rms_norm():
    (jx, js), (tx, ts) = both(*arrays(0, (2, 5, 64), (64,)))
    close(tops.rms_norm(tx, ts, 1e-5), jops.rms_norm(jx, js, 1e-5))


def test_rms_norm_casts_before_scaling():
    """Normalise in float32, cast, then scale in the model dtype."""
    x, s = arrays(1, (3, 64), (64,))
    got = tops.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(s).bfloat16())
    x32 = torch.from_numpy(x).bfloat16().float()
    want = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)).bfloat16() \
        * torch.from_numpy(s).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("positions", [np.arange(7), np.array([[3], [11]])],
                         ids=["prefill", "decode"])
def test_rope(positions):
    s = positions.shape[-1] if positions.ndim == 1 else 1
    (jx,), (tx,) = both(*arrays(2, (2, s, 4, 16)))
    close(tops.rope(tx, torch.from_numpy(positions), 1e6),
          jops.rope(jx, jnp.asarray(positions), 1e6))


def test_swiglu():
    x, g, u, d = arrays(3, (2, 5, 64), (64, 128), (64, 128), (128, 64))
    # weights as init_params draws them: normal / sqrt(fan_in)
    (jx, jg, ju, jd), (tx, tg, tu, td) = both(x, g / 8, u / 8, d / np.sqrt(128).astype(np.float32))
    close(tops.swiglu(tx, tg, tu, td), jops.swiglu(jx, jg, ju, jd))


@pytest.mark.parametrize("s_q,s_k,off", [(5, 5, 0), (3, 9, 6), (4, 2, 1)])
def test_causal_mask_bias(s_q, s_k, off):
    np.testing.assert_array_equal(tops.causal_mask_bias(s_q, s_k, off).numpy(),
                                  np.asarray(jops.causal_mask_bias(s_q, s_k, off)))


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 3), (False, 0)])
def test_naive_attention(causal, off):
    (jq, jk, jv), (tq, tk, tv) = both(*arrays(4, (2, 6, 2, 2, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    close(tops._naive_attention(tq, tk, tv, causal=causal, q_offset=off),
          jops._naive_attention(jq, jk, jv, causal=causal, q_offset=off))


@pytest.mark.parametrize("s,t,chunk,causal,off", [
    (13, 13, 4, True, 0),    # ragged: queries and keys padded
    (5, 13, 4, True, 8),     # a decode-like window past a prefix
    (13, 13, 4, False, 0),   # bidirectional, padded
    (8, 8, 4, True, 0),      # no padding: the diagonal chunks only
    (3, 7, 16, True, 4),     # one chunk wider than both
])
def test_chunked_attention(s, t, chunk, causal, off):
    (jq, jk, jv), (tq, tk, tv) = both(*arrays(5, (2, s, 2, 2, 16), (2, t, 2, 16), (2, t, 2, 16)))
    close(tops._chunked_attention(tq, tk, tv, causal=causal, q_offset=off, chunk=chunk),
          jops._chunked_attention(jq, jk, jv, causal=causal, q_offset=off, chunk=chunk))


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_gqa_attention(impl):
    (jq, jk, jv), (tq, tk, tv) = both(*arrays(6, (1, 11, 4, 16), (1, 11, 2, 16), (1, 11, 2, 16)))
    close(tops.gqa_attention(tq, tk, tv, causal=True, impl=impl, chunk=4),
          jops.gqa_attention(jq, jk, jv, causal=True, impl=impl, chunk=4), atol=2e-5, rtol=2e-5)


def test_decode_attention_per_row_lengths():
    (jq, jk, jv), (tq, tk, tv) = both(*arrays(7, (3, 1, 4, 16), (3, 10, 2, 16), (3, 10, 2, 16)))
    lengths = np.array([1, 6, 10], np.int32)
    close(tops.decode_attention(tq, tk, tv, torch.from_numpy(lengths)),
          jops.decode_attention(jq, jk, jv, jnp.asarray(lengths)))
    close(tops.decode_attention(tq, tk, tv, 4), jops.decode_attention(jq, jk, jv, 4))


def test_constrain_checks_rank_and_returns_its_input():
    x = torch.zeros(2, 3)
    assert constrain(x, "batch", None) is x
    with pytest.raises(ValueError, match="rank 2 != 3"):
        constrain(x, "batch", "seq", "d_model")


def test_attn_block():
    cfg, jcfg = qwen(), jqwen()
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    jbp = jax.tree.map(lambda a: a[0], jp["blocks"])
    (jh,), (th,) = both(*arrays(8, (2, 7, cfg.d_model)))
    pos = np.arange(7)
    close(tmodel._attn(th, tp["blocks"][0], cfg, causal=True, positions=torch.from_numpy(pos)),
          jmodel._attn(jh, jbp, jcfg, causal=True, positions=jnp.asarray(pos)), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# models/init.py
# ---------------------------------------------------------------------------

def test_init_params_has_the_reference_names_and_shapes():
    cfg, jcfg = qwen(), jqwen()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in tp.named_children()) == ["blocks"]
    assert sorted(n for n, _ in tp.named_parameters(recurse=False)) == \
        sorted(k for k in jp if k != "blocks")
    assert len(tp["blocks"]) == cfg.n_layers
    for name, stacked in jp["blocks"].items():
        for bp in tp["blocks"]:
            assert bp[name].shape == stacked.shape[1:] and bp[name].dtype == torch.float32, name
    for name in ("embed", "final_norm", "lm_head"):
        assert tp[name].shape == jp[name].shape
    assert not any(p.requires_grad for p in tp.parameters())


def test_init_params_draws_the_reference_distributions():
    cfg = qwen(d_model=256, d_ff=512, dtype="bfloat16")
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    bp = tp["blocks"][0]
    assert tp["embed"].dtype == torch.bfloat16
    for name in ("attn_norm", "ffn_norm"):
        assert torch.equal(bp[name], torch.ones_like(bp[name]))
    assert torch.equal(tp["final_norm"], torch.ones_like(tp["final_norm"]))
    # normal / sqrt(fan_in); fan_in of wo is heads*head_dim, of bq its heads
    for name, fan_in in (("wq", 256), ("w_down", 512), ("wo", 4 * 16), ("bq", 4)):
        std = float(bp[name].float().std())
        assert abs(std * np.sqrt(fan_in) - 1) < 0.1, (name, std)
    for name in ("embed", "lm_head"):
        assert abs(float(tp[name].float().std()) * 16 - 1) < 0.05
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["blocks"][1]["wk"], tp["blocks"][1]["wk"])
    other = init_params(cfg, torch.Generator().manual_seed(1))
    assert not torch.equal(other["embed"], tp["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_every_value(dtype):
    cfg, jcfg = qwen(dtype=dtype), jqwen(dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    for name, stacked in jp["blocks"].items():
        for i, bp in enumerate(tp["blocks"]):
            assert bp[name].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(bp[name].float().numpy(), np.asarray(stacked[i], np.float32))
    np.testing.assert_array_equal(tp["embed"].float().numpy(), np.asarray(jp["embed"], np.float32))


@pytest.mark.parametrize("arch", ["mamba2-370m", "granite-moe-3b-a800m", "zamba2-7b",
                                  "whisper-tiny", "internvl2-76b"])
def test_other_families_are_not_ported_yet(arch):
    """Serving ports the dense family; the ssm family has parameters (the
    training slice) but no cache yet."""
    cfg = reduced(get_config(arch))
    if cfg.family == "ssm":
        assert len(init_params(cfg, torch.Generator().manual_seed(0))["blocks"]) == cfg.n_layers
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
            init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=cfg.family):
        init_cache(cfg, 1, 8)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    set_default_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_default_device\\('cpu'\\)"):
        init_cache(qwen(), 1, 8)
    assert init_cache(qwen(), 1, 8, device="cpu")["k"].device.type == "cpu"


# ---------------------------------------------------------------------------
# models/model.py: prefill and decode_step against the reference
# ---------------------------------------------------------------------------

def run_reference(jcfg, jp, prompts, n_steps, cache_len):
    cache = jinit_cache(jcfg, prompts.shape[0], cache_len)
    logits, cache = jax.jit(lambda p, t, c: jprefill(p, jcfg, t, c))(jp, jnp.asarray(prompts), cache)
    out, tokens = [np.asarray(logits, np.float32)], []
    step = jax.jit(lambda p, t, c: jdecode_step(p, jcfg, t, c))
    for _ in range(n_steps):
        nxt = np.asarray(jnp.argmax(logits[:, : jcfg.vocab], axis=-1), np.int32)[:, None]
        tokens.append(nxt)
        logits, cache = step(jp, jnp.asarray(nxt), cache)
        out.append(np.asarray(logits, np.float32))
    return out, tokens, cache


def run_port(cfg, tp, prompts, tokens, cache_len):
    cache = init_cache(cfg, prompts.shape[0], cache_len)
    with torch.inference_mode():
        logits, cache = prefill(tp, cfg, torch.from_numpy(prompts), cache)
        out = [logits.float().numpy()]
        for nxt in tokens:  # the reference's tokens, so a near-tie cannot fork the runs
            logits, cache = decode_step(tp, cfg, torch.tensor(nxt), cache)
            out.append(logits.float().numpy())
    return out, cache


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_prefill_and_decode_logits_match_reference(impl):
    cfg, jcfg = qwen(attn_impl=impl, attn_chunk=8), jqwen(attn_impl=impl, attn_chunk=8)
    jp = jinit_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    ref, tokens, jcache = run_reference(jcfg, jp, prompts, 4, 24)
    got, cache = run_port(cfg, tp, prompts, tokens, 24)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"call {i}")
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=1e-4, rtol=1e-4)


def test_bf16_logits_match_reference_within_a_few_ulps():
    """bf16 keeps 8 significant bits, and XLA and torch round intermediate
    results at different places (XLA fuses elementwise chains in float32),
    so the logits may differ by a few bf16 ulps of their magnitude (measured:
    2 ulps).  The bound is 4 ulps of the largest reference logit."""
    cfg, jcfg = qwen(dtype="bfloat16"), jqwen(dtype="bfloat16")
    jp = jinit_params(jcfg, jax.random.PRNGKey(4))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    ref, tokens, _ = run_reference(jcfg, jp, prompts, 4, 24)
    got, _ = run_port(cfg, tp, prompts, tokens, 24)
    top = max(float(np.abs(r).max()) for r in ref)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=4 * ulp, rtol=0)


def test_prefill_overwrites_a_used_cache():
    cfg = qwen()
    tp = init_params(cfg, torch.Generator().manual_seed(5))
    prompt = torch.arange(1, 6)[None]
    fresh, _ = prefill(tp, cfg, prompt, init_cache(cfg, 1, 16))
    used = init_cache(cfg, 1, 16)
    used["k"].fill_(7.0)
    used["v"].fill_(-3.0)
    again, used = prefill(tp, cfg, prompt, used)
    assert torch.equal(fresh, again)
    assert torch.equal(used["k"][:, :, 5:], torch.zeros_like(used["k"][:, :, 5:]))
    with pytest.raises(ValueError, match="does not fit"):
        prefill(tp, cfg, torch.arange(20)[None], init_cache(cfg, 1, 16))
