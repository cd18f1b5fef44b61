"""The port's serving engine on the CPU, against the JAX package.

``repro_torch.serving.ServeEngine`` must generate exactly the reference
engine's tokens, in float32, for the four scenarios of
``tests/test_serving.py``, with the reference's weights carried across by
``params_from_numpy``: for the dense family (qwen2.5-3b), the ssm family
(mamba2-370m) and the moe family (granite-moe-3b-a800m).  The hybrid family
(zamba2-7b) must generate the tokens of greedy decoding by the reference's
full-sequence forward, which its own engine misses (its decode feeds the
shared block the previous token's embedding).  The dissemination twin of
``examples/serve_decode.py`` runs here on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import forward_hidden as jforward_hidden  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import lm_logits as jlm_logits  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import build_fdb  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.models import (  # noqa: E402
    CACHE_BATCH_AXIS,
    decode_step,
    init_cache,
    init_params,
    params_from_numpy,
    prefill,
)
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.serving.engine import _insert_slot  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("qwen2.5-3b"))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen2.5-3b"))
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"), jcfg, jp


def serve(engine_cls, request_cls, params, cfg, jobs, max_batch):
    """Run (prompt, max_new_tokens, eos_id) jobs; generations in submit order."""
    eng = engine_cls(params, cfg, max_batch=max_batch, cache_len=64)
    reqs = [request_cls(prompt=p, max_new_tokens=n, eos_id=e) for p, n, e in jobs]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert sorted(id(r) for r in done) == sorted(id(r) for r in reqs)
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], eng


def sequential_generate(params, cfg, prompt, n_tokens):
    """Single-request prefill + greedy decode on the port."""
    with torch.inference_mode():
        logits, cache = prefill(params, cfg, torch.tensor(prompt)[None], init_cache(cfg, 1, 64))
        out = [int(torch.argmax(logits[0, : cfg.vocab]))]
        for _ in range(n_tokens - 1):
            logits, cache = decode_step(params, cfg, torch.tensor([[out[-1]]]), cache)
            out.append(int(torch.argmax(logits[0, : cfg.vocab])))
    return out


def scenario(name, vocab):
    """The jobs and batch size of each test of tests/test_serving.py."""
    if name == "single_request":
        return [(np.arange(1, 9, dtype=np.int32), 6, None)], 2
    if name == "batched_requests":
        rng = np.random.default_rng(0)
        return [(rng.integers(1, vocab, size=n).astype(np.int32), 5, None) for n in (5, 8, 11)], 2
    if name == "admission_mid_flight":
        rng = np.random.default_rng(1)
        p1 = rng.integers(1, vocab, size=4).astype(np.int32)
        p2 = rng.integers(1, vocab, size=12).astype(np.int32)
        return [(p1, 8, None), (p2, 3, None)], 2
    raise KeyError(name)


SCENARIOS = ["single_request", "batched_requests", "admission_mid_flight", "eos_stops_early"]


@pytest.fixture(scope="module", params=["mamba2-370m", "granite-moe-3b-a800m"])
def family_setup(request):
    jcfg = jreduced(jget_config(request.param))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"), jcfg, jp


@pytest.mark.parametrize("name", SCENARIOS)
def test_ssm_and_moe_generations_equal_the_reference_engine(family_setup, name):
    """The four scenarios of tests/test_serving.py on the ssm and moe families:
    their caches (conv and ssm states; keys and values) go through the slots."""
    cfg, params, jcfg, jp = family_setup
    if name == "eos_stops_early":
        prompt = np.arange(1, 6, dtype=np.int32)
        jobs, max_batch = [(prompt, 50, sequential_generate(params, cfg, prompt, 1)[0])], 1
    else:
        jobs, max_batch = scenario(name, cfg.vocab)
    got, _ = serve(ServeEngine, Request, params, cfg, jobs, max_batch)
    want, _ = serve(JServeEngine, JRequest, jp, jcfg, jobs, max_batch)
    assert got == want
    if not cfg.moe.enabled:
        # a moe decode step routes the batch's tokens as one dispatch group,
        # whose capacity depends on the batch: batched and sequential decode
        # differ by design, in both packages
        for gen, (prompt, n, eos) in zip(got, jobs):
            assert gen[:n] == sequential_generate(params, cfg, prompt, len(gen))
    if name == "eos_stops_early":
        assert got == [[jobs[0][2]]]


def test_hybrid_generations_equal_greedy_decoding_by_the_reference_forward():
    """zamba2 behind the engine, three requests over two slots: every token
    is the argmax of the reference's forward over the prompt and the tokens
    before it (run at a fixed length, as a causal forward's logits at a
    position do not depend on later ones)."""
    jcfg = jreduced(jget_config("zamba2-7b"))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("zamba2-7b"))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    jobs, max_batch = scenario("batched_requests", cfg.vocab)
    got, _ = serve(ServeEngine, Request, params, cfg, jobs, max_batch)
    width = max(len(p) + n for p, n, _ in jobs)

    @jax.jit
    def forward_logits(tokens):
        return jlm_logits(jp, jcfg, jforward_hidden(jp, jcfg, tokens)[0])

    for gen, (prompt, n, _) in zip(got, jobs):
        seq = list(prompt)
        for _ in range(n):
            logits = forward_logits(jnp.asarray(np.pad(seq, (0, width - len(seq)))[None], jnp.int32))
            seq.append(int(jnp.argmax(logits[0, len(seq) - 1, : cfg.vocab])))
        assert gen == seq[len(prompt):]


def test_the_engine_refuses_the_audio_family():
    cfg = reduced(get_config("whisper-tiny"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="audio family .* needs enc_frames"):
        ServeEngine(params, cfg)


@pytest.mark.parametrize("name", ["single_request", "batched_requests", "admission_mid_flight"])
def test_generations_equal_the_reference_engine(setup, name):
    cfg, params, jcfg, jp = setup
    jobs, max_batch = scenario(name, cfg.vocab)
    got, _ = serve(ServeEngine, Request, params, cfg, jobs, max_batch)
    want, _ = serve(JServeEngine, JRequest, jp, jcfg, jobs, max_batch)
    assert got == want
    for gen, (prompt, n, _) in zip(got, jobs):
        assert gen[:n] == sequential_generate(params, cfg, prompt, n)


def test_eos_stops_early_as_in_the_reference(setup):
    cfg, params, jcfg, jp = setup
    prompt = np.arange(1, 6, dtype=np.int32)
    first = sequential_generate(params, cfg, prompt, 1)[0]
    jobs = [(prompt, 50, first)]
    got, _ = serve(ServeEngine, Request, params, cfg, jobs, 1)
    want, _ = serve(JServeEngine, JRequest, jp, jcfg, jobs, 1)
    assert got == want == [[first]]


def test_eos_mid_decode_is_part_of_the_output(setup):
    cfg, params, jcfg, jp = setup
    prompt = np.arange(3, 12, dtype=np.int32)
    seq = sequential_generate(params, cfg, prompt, 6)
    jobs = [(prompt, 20, seq[3])]
    got, _ = serve(ServeEngine, Request, params, cfg, jobs, 2)
    want, _ = serve(JServeEngine, JRequest, jp, jcfg, jobs, 2)
    assert got == want
    assert got[0] == seq[: seq.index(seq[3]) + 1]


def test_stats_count_prefills_and_decoded_tokens(setup):
    cfg, params, _, _ = setup
    jobs, max_batch = scenario("batched_requests", cfg.vocab)
    gens, eng = serve(ServeEngine, Request, params, cfg, jobs, max_batch)
    st = eng.stats
    assert st["prefills"] == 3
    assert st["prefill_tokens"] == sum(len(p) for p, _, _ in jobs)
    assert st["decode_tokens"] == sum(len(g) for g in gens) - 3  # one token each from prefill
    assert st["decode_steps"] >= max(len(g) for g in gens)
    assert st["prefill_s"] > 0 and st["decode_s"] > 0


def test_requests_that_exceed_the_cache_are_refused(setup):
    cfg, params, _, _ = setup
    eng = ServeEngine(params, cfg, max_batch=1, cache_len=16)
    eng.submit(Request(prompt=np.arange(1, 12, dtype=np.int32), max_new_tokens=6))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.run()


def test_insert_slot_writes_one_slot_in_place():
    cfg = reduced(get_config("qwen2.5-3b"))
    batch = init_cache(cfg, 3, 8)
    single = init_cache(cfg, 1, 8)
    single["k"].fill_(2.0)
    single["v"].fill_(-1.0)
    single["pos"].fill_(5)
    k_before = batch["k"]
    out = _insert_slot(batch, single, 1)
    assert out is batch and out["k"] is k_before
    assert torch.equal(out["k"][:, 1], single["k"][:, 0])
    assert torch.equal(out["v"][:, 1], single["v"][:, 0])
    assert not out["k"][:, [0, 2]].any() and not out["v"][:, [0, 2]].any()
    assert not out["pos"].any()  # positions stay host-managed


def test_insert_slot_writes_one_slot_of_every_hybrid_cache_entry():
    """conv, ssm, shared_k/v carry their batch on axis 1, x0 on axis 0."""
    cfg = reduced(get_config("zamba2-7b"))
    batch = init_cache(cfg, 3, 8)
    single = init_cache(cfg, 1, 8)
    assert sorted(single) == ["conv", "pos", "shared_k", "shared_v", "ssm", "x0"]
    for i, name in enumerate(sorted(single)):
        single[name].fill_(i + 1)
    _insert_slot(batch, single, 2)
    for name, t in batch.items():
        if name == "pos":
            assert not t.any()
            continue
        got = t.movedim(CACHE_BATCH_AXIS[name], 0)
        assert torch.equal(got[2], single[name].movedim(CACHE_BATCH_AXIS[name], 0)[0]), name
        assert not got[:2].any(), name


def test_cache_tier_builds_on_the_port(tmp_path):
    """The dissemination tier: ``{"type": "cache"}`` is carried over now."""
    cfg = {"type": "cache", "max_bytes": 1 << 20,
           "inner": {"backend": "posix", "root": str(tmp_path), "schema": "nwp-posix"}}
    key = {"class": "rd", "stream": "oper", "expver": "0001", "date": "20240601",
           "time": "0000", "type": "fc", "levtype": "ml", "number": "0",
           "levelist": "1", "step": "0", "param": "130"}
    with build_fdb(cfg) as fdb:
        fdb.archive(key, b"token+logits")
        fdb.flush()
        assert fdb.read(key) == b"token+logits"
        assert fdb.read(key) == b"token+logits"
        snap = fdb.cache_snapshot()
    assert snap["hits"] >= 1 and snap["misses"] >= 1


def test_serve_decode_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_decode_torch.py"), "--device", "cpu",
         "--batch", "2", "--prompt-len", "9", "--tokens", "5", "--consumers", "3"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "attn=pallas" in out.stdout
    assert "disseminate: 3 consumers x 10 fields" in out.stdout
    assert "hit rate" in out.stdout
