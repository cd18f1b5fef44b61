"""The port's serving engine on the CPU, against the JAX package.

``repro_torch.serving.ServeEngine`` must generate exactly the reference
engine's tokens, in float32, for the four scenarios of
``tests/test_serving.py``, with the reference's weights carried across by
``params_from_numpy``.  The dissemination twin of ``examples/serve_decode.py``
runs here on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import build_fdb  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.models import decode_step, init_cache, params_from_numpy, prefill  # noqa: E402
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
