"""Every model family of the port on the CPU, against the JAX package.

For each entry of ``repro.configs.ARCHS`` at ``reduced()`` in float32, with
the reference's ``init_params`` carried across by ``params_from_numpy``:
``train_loss`` (loss, ce, aux) and ``forward_hidden``, ``prefill`` logits and
every cache entry, and two ``decode_step``s, all within 1e-4 of the
reference; and one gradient of the port's loss, finite.  The hybrid family's
decode is held against the reference's *forward* instead: the reference's
``decode_step`` feeds its shared block the previous token's embedding, a
fault the port fixes, and a test pins both sides of that.  ``moe_ffn``,
``router_topk`` and ``mamba_decode_step`` are held against the reference's
one by one, and the limits both packages share (a moe dispatch group that
does not divide the tokens, an ssm prompt shorter than its conv window) are
pinned.  Inputs come from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import encode as jencode  # noqa: E402
from repro.models import forward_hidden as jforward_hidden  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import lm_logits as jlm_logits  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import train_loss as jtrain_loss  # noqa: E402
from repro.models.moe import moe_ffn as jmoe_ffn  # noqa: E402
from repro.models.moe import router_topk as jrouter_topk  # noqa: E402
from repro.models.ssm import init_ssm_state as jinit_ssm_state  # noqa: E402
from repro.models.ssm import mamba_decode_step as jmamba_decode_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.models import (  # noqa: E402
    CACHE_BATCH_AXIS,
    decode_step,
    encode,
    forward_hidden,
    init_cache,
    init_params,
    init_ssm_state,
    params_from_numpy,
    prefill,
    train_loss,
)
from repro_torch.models.moe import moe_ffn, router_topk  # noqa: E402
from repro_torch.models.ssm import mamba_decode_step  # noqa: E402
from repro_torch.tree import leaf_groups  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, S0, CACHE = 2, 64, 16, 32  # train batch x tokens, prompt tokens, cache length


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def close(t, j, what=""):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL,
                               err_msg=what)


def make_batch(cfg, seed=0):
    """tests/test_arch_smoke.py's batch, from numpy: targets, tokens, and the
    frames of the audio family or the patch embeddings of the vlm family."""
    rng = np.random.default_rng(seed)
    batch = {"targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    if cfg.input_kind == "patches":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    return batch


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    jcfg = jreduced(jget_config(request.param))
    cfg = reduced(get_config(request.param))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jp, make_batch(cfg)


def port_params(cfg, jp):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def model_inputs(cfg, batch, lib):
    """(inputs of forward_hidden, encoder frames or None) as ``lib`` arrays."""
    to = jnp.asarray if lib == "jax" else torch.from_numpy
    frames = to(batch["frames"]) if cfg.is_encoder_decoder else None
    inputs = batch["embeds"] if cfg.input_kind == "patches" else batch["tokens"]
    return to(inputs), frames


def test_train_loss_and_forward_match_reference(arch):
    cfg, jcfg, jp, batch = arch
    tp = port_params(cfg, jp)

    def jrun(p, b):
        inputs, frames = model_inputs(jcfg, b, "jax")
        enc = jencode(p, jcfg, frames) if frames is not None else None
        return jtrain_loss(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()}), \
            jforward_hidden(p, jcfg, inputs, enc_out=enc)

    (jloss, jm), (jh, jaux) = jax.jit(jrun)(jp, batch)
    with torch.no_grad():
        loss, m = train_loss(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        inputs, frames = model_inputs(cfg, batch, "torch")
        enc = encode(tp, cfg, frames) if frames is not None else None
        h, aux = forward_hidden(tp, cfg, inputs, enc_out=enc)
    close(loss, jloss, "loss")
    close(m["ce"], jm["ce"], "ce")
    close(m["aux"], jm["aux"], "aux")
    close(h, jh, "forward_hidden")
    close(aux, jaux, "forward aux")
    if cfg.moe.enabled:
        assert float(m["aux"]) > 0  # the load-balance loss is live


def prefill_inputs(cfg, batch):
    """S0 prompt tokens (patch embeddings for the vlm family) and the frames."""
    key = "embeds" if cfg.input_kind == "patches" else "tokens"
    frames = batch["frames"] if cfg.is_encoder_decoder else None
    return np.ascontiguousarray(batch[key][:, :S0]), frames


def run_reference(jcfg, jp, batch, n_steps):
    prompt, frames = prefill_inputs(jcfg, batch)
    kw = {"enc_frames": jnp.asarray(frames)} if frames is not None else {}
    cache = jinit_cache(jcfg, B, CACHE)
    logits, cache = jax.jit(lambda p, t, c: jprefill(p, jcfg, t, c, **kw))(jp, jnp.asarray(prompt), cache)
    out = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    step = jax.jit(lambda p, t, c: jdecode_step(p, jcfg, t, c))
    tokens = []
    for _ in range(n_steps):
        nxt = np.array(jnp.argmax(logits[:, : jcfg.vocab], axis=-1), np.int32)[:, None]
        tokens.append(nxt)
        logits, cache = step(jp, jnp.asarray(nxt), cache)
        out.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return out, tokens


def run_port(cfg, tp, batch, tokens):
    prompt, frames = prefill_inputs(cfg, batch)
    cache = init_cache(cfg, B, CACHE, enc_len=S if frames is not None else 0)
    kw = {"enc_frames": torch.from_numpy(frames)} if frames is not None else {}

    def snapshot(logits, cache):
        return logits.clone(), {k: v.clone() for k, v in cache.items()}

    with torch.inference_mode():
        out = [snapshot(*prefill(tp, cfg, torch.from_numpy(prompt), cache, **kw))]
        for nxt in tokens:  # the reference's tokens, so a near-tie cannot fork the runs
            out.append(snapshot(*decode_step(tp, cfg, torch.from_numpy(nxt), cache)))
    return out


def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and every cache entry, then two decode steps; the
    hybrid family's decode is held against the forward instead (below)."""
    cfg, jcfg, jp, batch = arch
    ref, tokens = run_reference(jcfg, jp, batch, 2)
    got = run_port(cfg, port_params(cfg, jp), batch, tokens)
    calls = got[:1] if cfg.family == "hybrid" else got
    for i, ((logits, cache), (jlogits, jcache)) in enumerate(zip(calls, ref)):
        close(logits, jlogits, f"logits of call {i}")
        assert sorted(cache) == sorted(jcache), (sorted(cache), sorted(jcache))
        for name in jcache:
            assert cache[name].shape == jcache[name].shape, name
            assert CACHE_BATCH_AXIS[name] in range(cache[name].ndim)
            close(cache[name], jcache[name], f"cache {name} after call {i}")


def test_one_gradient_is_finite(arch):
    cfg, _, jp, batch = arch
    cfg = dataclasses.replace(cfg, attn_impl="naive")
    tp = port_params(cfg, jp).requires_grad_(True)
    loss, _ = train_loss(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert np.isfinite(float(loss.detach())) and float(loss.detach()) > 0
    grads = dict(tp.named_parameters())
    # the vlm family reads patch embeddings, not its embedding table
    unused = {"embed"} if cfg.input_kind == "patches" else set()
    assert {n for n, p in grads.items() if p.grad is None} == unused
    bad = [n for n, p in grads.items() if p.grad is not None and not torch.isfinite(p.grad).all()]
    assert not bad, bad


def test_params_tree_has_the_reference_leaf_names(arch):
    """Checkpoint names: the port's tree() gives the reference's leaves, by
    name and stacked shape, so both packages restore each other's."""
    cfg, _, jp, _ = arch
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = {name: (len(ts), *ts[0].shape) if stacked else tuple(ts[0].shape)
           for name, ts, stacked in leaf_groups({"params": tp.tree()})}
    flat = jax.tree_util.tree_flatten_with_path({"params": jp})[0]
    want = {jax.tree_util.keystr(p).replace("'", "").replace("[", ".").replace("]", "").strip("."):
            tuple(a.shape) for p, a in flat}
    assert got == want
    again = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    again.copy_from(tp.tree())
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), tp.parameters()))


# ---------------------------------------------------------------------------
# hybrid decode: the reference's fault, the port's fix
# ---------------------------------------------------------------------------

def hybrid_setup():
    jcfg, cfg = jreduced(jget_config("zamba2-7b")), reduced(get_config("zamba2-7b"))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, 2 * S0)).astype(np.int32)
    return cfg, jcfg, jp, tokens


def reference_forward_logits(jcfg, jp, tokens):
    """Logits at every position of the reference's full-sequence forward."""
    h, _ = jax.jit(lambda p, t: jforward_hidden(p, jcfg, t))(jp, jnp.asarray(tokens))
    return np.asarray(jlm_logits(jp, jcfg, h))


def test_hybrid_decode_continues_the_forward_where_the_reference_does_not():
    """Prefill S0 tokens, then decode the next ones: the port's logits equal
    the reference's forward at those positions within 1e-4; the reference's
    own decode misses them by more than 0.1 (0.268 measured in float32 at
    seed 0, against 1.4e-6 for its prefill)."""
    cfg, jcfg, jp, tokens = hybrid_setup()
    want = reference_forward_logits(jcfg, jp, tokens)
    tp = port_params(cfg, jp)
    cache = init_cache(cfg, B, 2 * S0)
    jcache = jinit_cache(jcfg, B, 2 * S0)
    with torch.inference_mode():
        logits, cache = prefill(tp, cfg, torch.from_numpy(tokens[:, :S0]), cache)
    jlogits, jcache = jax.jit(lambda p, t, c: jprefill(p, jcfg, t, c))(
        jp, jnp.asarray(tokens[:, :S0]), jcache)
    close(logits, want[:, S0 - 1], "port prefill")
    np.testing.assert_allclose(np.asarray(jlogits), want[:, S0 - 1], **TOL)  # the reference's prefill
    step = jax.jit(lambda p, t, c: jdecode_step(p, jcfg, t, c))
    ref_gap = 0.0
    for t in range(S0, 2 * S0):
        nxt = tokens[:, t:t + 1]
        with torch.inference_mode():
            logits, cache = decode_step(tp, cfg, torch.from_numpy(nxt), cache)
        jlogits, jcache = step(jp, jnp.asarray(nxt), jcache)
        close(logits, want[:, t], f"port decode at position {t}")
        ref_gap = max(ref_gap, float(np.abs(np.asarray(jlogits) - want[:, t]).max()))
    assert ref_gap > 0.1, ref_gap


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,e,k,capacity", [(16, 4, 2, 3), (32, 8, 3, 5), (8, 40, 8, 1)])
def test_router_topk_matches_reference(g, e, k, capacity):
    """Dispatch, combine and aux on tie-free float32 logits, with tokens
    dropped past each expert's capacity."""
    moe = dataclasses.replace(get_config("granite-moe-3b-a800m").moe, n_experts=e, top_k=k)
    logits = np.random.default_rng(g + e).standard_normal((2, g, e), dtype=np.float32)
    d, c, aux = router_topk(torch.from_numpy(logits), moe, capacity)
    jd, jc, jaux = jrouter_topk(jnp.asarray(logits), moe, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    close(c, jc, "combine")
    close(aux, jaux, "aux")
    assert float(d.sum()) < 2 * g * k  # some choices were dropped


@pytest.mark.parametrize("arch_name,pad_to", [("granite-moe-3b-a800m", 0),
                                              ("phi3.5-moe-42b-a6.6b", 0),
                                              ("granite-moe-3b-a800m", 6)])
def test_moe_ffn_matches_reference(arch_name, pad_to):
    """Two dispatch groups; with padded expert slots, none is routed to."""
    over = {"moe": dataclasses.replace(reduced(get_config(arch_name)).moe, pad_experts_to=pad_to)}
    cfg = reduced(get_config(arch_name), **over)
    jcfg = jreduced(jget_config(arch_name), **over)
    jbp = jax.tree.map(lambda a: a[0], jinit_params(jcfg, jax.random.PRNGKey(2))["blocks"])
    bp = {name: torch.from_numpy(np.array(a)) for name, a in jbp.items()}
    x = np.random.default_rng(3).standard_normal((2, cfg.moe.group_size, cfg.d_model),
                                                  dtype=np.float32)
    out, aux = moe_ffn(torch.from_numpy(x), bp, cfg.moe)
    jout, jaux = jmoe_ffn(jnp.asarray(x), jbp, jcfg.moe)
    close(out, jout, "moe_ffn")
    close(aux, jaux, "aux")
    if pad_to:
        logits = torch.from_numpy(x).reshape(-1, cfg.d_model) @ bp["router"]
        logits[:, cfg.moe.n_experts:] = -1e9
        d, _, _ = router_topk(logits[None], cfg.moe, 64)
        assert not d[..., cfg.moe.n_experts:, :].any()


def test_a_moe_prompt_past_one_group_that_does_not_divide_is_refused_by_both():
    """group_size + 1 tokens: the reference's reshape fails, the port names
    both numbers."""
    cfg, jcfg = reduced(get_config("granite-moe-3b-a800m")), jreduced(jget_config("granite-moe-3b-a800m"))
    n = cfg.moe.group_size + 1
    prompt = np.arange(1, n + 1, dtype=np.int32)[None]
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        jprefill(jp, jcfg, jnp.asarray(prompt), jinit_cache(jcfg, 1, 64))
    tp = port_params(cfg, jp)
    with pytest.raises(ValueError, match=f"{n} tokens .* group_size {cfg.moe.group_size}"):
        prefill(tp, cfg, torch.from_numpy(prompt), init_cache(cfg, 1, 64))
    # a whole number of groups runs
    prefill(tp, cfg, torch.from_numpy(prompt[:, :-1]).repeat(2, 1), init_cache(cfg, 2, 64))


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_name", ["mamba2-370m", "zamba2-7b"])
def test_mamba_decode_step_matches_reference(arch_name):
    cfg, jcfg = reduced(get_config(arch_name)), jreduced(jget_config(arch_name))
    jbp = jax.tree.map(lambda a: a[0], jinit_params(jcfg, jax.random.PRNGKey(4))["blocks"])
    bp = {name: torch.from_numpy(np.array(a)) for name, a in jbp.items()}
    shapes = {k: v.shape for k, v in jinit_ssm_state(jcfg, 3, jnp.float32).items()}
    rng = np.random.default_rng(4)
    state = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    zeros = init_ssm_state(cfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in zeros.items()} == shapes
    assert zeros["ssm"].dtype == torch.float32 and not any(v.any() for v in zeros.values())
    y, st = mamba_decode_step(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in state.items()},
                              bp, cfg)
    jy, jst = jmamba_decode_step(jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
                                 jbp, jcfg)
    close(y, jy, "y")
    close(st["conv"], jst["conv"], "conv")
    close(st["ssm"], jst["ssm"], "ssm")


def test_ssm_prefill_of_a_ragged_prompt_continues_past_the_last_chunk():
    """A prompt longer than the chunk and not a multiple of it, which the
    reference's ssd_chunked refuses: the port runs the tail as a chunk of its
    own from the carried state, and its logits equal the reference's forward
    run as one chunk."""
    cfg = reduced(get_config("mamba2-370m"))
    n = cfg.ssm.chunk + 9
    jcfg = jreduced(jget_config("mamba2-370m"))
    jone = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=n))
    jp = jinit_params(jcfg, jax.random.PRNGKey(6))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, n)).astype(np.int32)
    with pytest.raises(AssertionError, match="not divisible"):
        jprefill(jp, jcfg, jnp.asarray(tokens), jinit_cache(jcfg, 2, n))
    want = reference_forward_logits(jone, jp, tokens)[:, -1]
    logits, _ = prefill(port_params(cfg, jp), cfg, torch.from_numpy(tokens), init_cache(cfg, 2, n))
    close(logits, want, "ragged prefill")


def test_an_ssm_prompt_shorter_than_the_conv_window_is_refused():
    cfg = reduced(get_config("mamba2-370m"))
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    k1 = cfg.ssm.d_conv - 1
    with pytest.raises(ValueError, match=f"shorter than the conv window's d_conv-1 = {k1}"):
        prefill(tp, cfg, torch.arange(1, k1)[None], init_cache(cfg, 1, 8))
    prefill(tp, cfg, torch.arange(1, k1 + 1)[None], init_cache(cfg, 1, 8))


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def test_audio_prefill_needs_frames_that_fit_its_cache():
    cfg = reduced(get_config("whisper-tiny"))
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.arange(1, 9)[None]
    frames = torch.randn(1, 12, cfg.d_model, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs enc_frames"):
        prefill(tp, cfg, prompt, init_cache(cfg, 1, 16, enc_len=12))
    with pytest.raises(ValueError, match="12 encoder frames do not fit .* enc_len 10"):
        prefill(tp, cfg, prompt, init_cache(cfg, 1, 16, enc_len=10), enc_frames=frames)
    logits, cache = prefill(tp, cfg, prompt, init_cache(cfg, 1, 16, enc_len=12), enc_frames=frames)
    assert logits.shape == (1, cfg.padded_vocab) and cache["xk"].abs().sum() > 0
