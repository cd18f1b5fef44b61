"""The step builders run as real DTensors on a (2, 2) ("data", "model") mesh
of 4 gloo ranks on the CPU, held against the same steps on plain tensors and
against the reference's builders on a 1x1 JAX mesh.

Every family that shards differently is here, at ``reduced()`` widths in
float32, with parameters carried from the reference's ``init_params``:
dense (qwen2.5-3b), moe with its experts split over `model` (expert
parallelism: 4 experts) and with them whole and their width split (tensor
parallelism inside the experts: 3 experts), ssm and hybrid.  Each runs
``build_train_step`` (ZeRO-1 optimizer state over `data`), ``build_prefill``
and ``build_decode``: the loss and metrics, every updated parameter, the
logits and every cache entry within 1e-4.

The shapes reach each sharded path: the train batch gives each data rank
one whole moe dispatch group (32 tokens), the prefill's one group of 32
spans both data ranks, and so does every moe decode batch.  Beside those,
the hybrid (and the dense) decode a batch of one, whose cache length is
split over `data` (flash-decoding), and the moe decodes 8 tokens as one
group spanning both data ranks at a capacity of 2 slots an expert, so that
tokens are dropped.  On a one-rank (1, 1) mesh, the moe prefill and the
hybrid decode of one row in bf16 give the plain steps' logits bit for bit.

One group of 4 ranks runs every step of every family, in a spawned process
each, and writes the full tensors, beside a one-rank process; the plain
steps and the reference's run in the test's process meanwhile."""

import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.distributed import AbstractMesh  # noqa: E402
from repro_torch.tree import leaf_groups  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
MESH = ((2, 2), ("data", "model"))
#: family -> (arch, moe overrides)
FAMILIES = {"dense": ("qwen2.5-3b", {}), "moe_ep": ("granite-moe-3b-a800m", {}),
            "moe_tp": ("granite-moe-3b-a800m", {"n_experts": 3}), "ssm": ("mamba2-370m", {}),
            "hybrid": ("zamba2-7b", {})}
B, S_TRAIN, S_PROMPT, CACHE = 2, 32, 16, 32
#: the extra decodes: (name, batch, moe overrides); a batch of one splits
#: the cache length over `data`, the moe's 8 tokens at 2 slots an expert drop
EXTRA = {"dense": [("decode_b1", 1, {})], "hybrid": [("decode_b1", 1, {})],
         "moe_ep": [("decode_drops", 8, {"capacity_factor": 0.5})],
         "moe_tp": [("decode_drops", 8, {"capacity_factor": 0.5})]}
# Adam's first step is lr * g / (|g| + eps); eps = 1 keeps it linear in the
# gradient, so the updated parameters hold the gradients to the tolerance
HP = dict(learning_rate=1.0, warmup_steps=1, eps=1.0)
JOIN_S = 240


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def port_config(family: str, **moe_over):
    arch, over = FAMILIES[family]
    cfg = reduced(get_config(arch))
    if over or moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over, **moe_over))
    return cfg


def reference_config(family: str, **moe_over):
    from repro.configs import get_config as jget_config, reduced as jreduced

    arch, over = FAMILIES[family]
    jcfg = jreduced(jget_config(arch))
    if over or moe_over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **over, **moe_over))
    return jcfg


def steps(family: str):
    """(name, batch, moe overrides) of every decode the family runs."""
    return [("decode", B, {})] + EXTRA.get(family, [])


def _run_steps(cfg_of, inp: dict, mesh, shard, full) -> dict:
    """Every step of one family through the builders on ``mesh``: ``shard``
    turns a builder's arguments into what its step takes, ``full`` a result
    into a whole tensor."""
    from repro_torch.launch import build_decode, build_prefill, build_train_step
    from repro_torch.models import init_cache, params_from_numpy, prefill
    from repro_torch.training.optimizer import init_opt_state

    cfg = cfg_of()
    out = {}
    params = params_from_numpy(cfg, inp["params"])
    fn, _, ins, _, _ = build_train_step(cfg, TrainConfig(**HP), mesh, ShapeConfig("t", S_TRAIN, B, "train"))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    params, _, metrics = fn(*shard((params, init_opt_state(params.tree()), batch), ins))
    out["train"] = ({k: float(full(v)) for k, v in metrics.items()},
                    {n: [full(t).detach().numpy().copy() for t in g] for n, g, _ in leaf_groups(params.tree())})
    with torch.no_grad():
        for name, b, moe_over in [("prefill", B, {})] + steps(inp["family"]):
            cfg = cfg_of(**moe_over)
            params = params_from_numpy(cfg, inp["params"])
            prompt = torch.from_numpy(inp["prompt"][:b])
            if name == "prefill":
                fn, _, ins, _, _ = build_prefill(cfg, mesh, ShapeConfig("p", S_PROMPT, b, "prefill"))
                args = (params, prompt, init_cache(cfg, b, S_PROMPT))
            else:
                fn, _, ins, _, _ = build_decode(cfg, mesh, ShapeConfig("d", CACHE, b, "decode"))
                _, cache = prefill(params, cfg, prompt, init_cache(cfg, b, CACHE))
                args = (params, torch.from_numpy(inp["token"][:b]), cache)
            logits, cache = fn(*shard(args, ins))
            out[name] = (full(logits).numpy(), {k: full(v).numpy().copy() for k, v in cache.items()})
    return out


def _port_ranks(rank: int, init: str, inputs_path: str, out_path: str) -> None:
    """One of the 4 ranks: every family's steps as DTensors; rank 0 writes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import shard_args

    set_default_device("cpu")
    torch.set_num_threads(1)  # the widths are tiny: 4 ranks, and the reference beside them
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731
        got = {family: _run_steps(lambda **o: port_config(family, **o), inp, mesh, shard_args, full)
               for family, inp in inputs.items()}
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def _one_rank(out_path: str) -> None:
    """bf16 steps as DTensors on a one-rank (1, 1) mesh beside the same steps
    on plain tensors, as chip_smoke's phase 10 holds them on the card: the
    moe prefill and the hybrid decode of one row."""
    import torch.distributed as dist

    from repro_torch.launch import build_decode, build_prefill, make_debug_mesh, shard_args
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    set_default_device("cpu")
    mesh = make_debug_mesh(device="cpu")
    got = {}
    try:
        toks = torch.randint(0, 256, (4, S_PROMPT + 1), generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            cfg = dataclasses.replace(port_config("moe_ep"), dtype="bfloat16")
            params = init_params(cfg, torch.Generator().manual_seed(0))
            fn, _, ins, _, _ = build_prefill(cfg, mesh, ShapeConfig("p", S_PROMPT, 4, "prefill"))
            sharded, _ = fn(*shard_args((params, toks[:, :-1], init_cache(cfg, 4, S_PROMPT)), ins))
            got["moe prefill"] = (sharded.to_local(), prefill(params, cfg, toks[:, :-1],
                                                              init_cache(cfg, 4, S_PROMPT))[0])
            cfg = dataclasses.replace(port_config("hybrid"), dtype="bfloat16")
            params = init_params(cfg, torch.Generator().manual_seed(0))
            fn, _, ins, _, _ = build_decode(cfg, mesh, ShapeConfig("d", CACHE, 1, "decode"))
            _, cache = prefill(params, cfg, toks[:1, :-1], init_cache(cfg, 1, CACHE))
            twin = {k: v.clone() for k, v in cache.items()}
            sharded, _ = fn(*shard_args((params, toks[:1, -1:], twin), ins))
            got["hybrid decode"] = (sharded.to_local(), decode_step(params, cfg, toks[:1, -1:], cache)[0])
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(got, f)


def _reference_steps(family: str, jp, inp: dict) -> dict:
    from repro.configs import TrainConfig as JTrainConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch.steps import build_decode, build_prefill, build_train_step
    from repro.models import init_cache, prefill
    from repro.models.model import embed_inputs

    # Auto axes, as in tests/test_torch_launch.py
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    out = {}
    with jax.set_mesh(mesh):
        from repro.training.optimizer import init_opt_state

        jcfg = reference_config(family)
        fn, *_ = build_train_step(jcfg, JTrainConfig(**HP), mesh, JShapeConfig("t", S_TRAIN, B, "train"))
        params, _, metrics = jax.jit(fn)(jp, init_opt_state(jp), {k: jnp.asarray(v) for k, v in
                                                                  inp["batch"].items()})
        out["train"] = ({k: float(v) for k, v in metrics.items()}, params)
        for name, b, moe_over in [("prefill", B, {})] + steps(family):
            jcfg = reference_config(family, **moe_over)
            prompt = jnp.asarray(inp["prompt"][:b])
            if name == "prefill":
                fn, *_ = build_prefill(jcfg, mesh, JShapeConfig("p", S_PROMPT, b, "prefill"))
                out[name] = jax.jit(fn)(jp, prompt, init_cache(jcfg, b, S_PROMPT))
                continue
            fn, *_ = build_decode(jcfg, mesh, JShapeConfig("d", CACHE, b, "decode"))
            _, cache = jax.jit(lambda p, t, c, cfg=jcfg: prefill(p, cfg, t, c))(
                jp, prompt, init_cache(jcfg, b, CACHE))
            token = jnp.asarray(inp["token"][:b])
            if "x0" in cache:
                # the reference's hybrid decode feeds its shared block the
                # previous token's embedding (a fault the port fixes)
                cache = {**cache, "x0": embed_inputs(jp, jcfg, token)}
            out[name] = jax.jit(fn)(jp, token, cache)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every family's steps three ways: as DTensors on 4 ranks, on plain
    tensors, and by the reference (while the ranks run)."""
    from repro.models import init_params as jinit_params

    set_default_device("cpu")  # module fixtures come before the autouse one
    d = tmp_path_factory.mktemp("sharded")
    inputs, jparams = {}, {}
    rng = np.random.default_rng(1)
    for family in FAMILIES:
        jcfg = reference_config(family)
        jparams[family] = jinit_params(jcfg, jax.random.PRNGKey(0))
        toks = rng.integers(0, jcfg.vocab, (8, S_TRAIN + 1)).astype(np.int32)
        inputs[family] = {"family": family, "params": jax.tree.map(np.asarray, jparams[family]),
                          "batch": {"tokens": toks[:B, :-1].copy(), "targets": toks[:B, 1:].copy()},
                          "prompt": toks[:, :S_PROMPT].copy(), "token": toks[:, S_PROMPT:S_PROMPT + 1].copy()}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    init = f"file://{d / 'store'}"
    procs = [ctx.Process(target=_port_ranks, args=(r, init, str(d / "in.pkl"), str(d / "out.pkl")))
             for r in range(4)] + [ctx.Process(target=_one_rank, args=(str(d / "one.pkl"),))]
    for p in procs:
        p.start()
    try:
        mesh = AbstractMesh(*MESH)  # the same builders on plain tensors: no process group
        plain = {family: _run_steps(lambda fam=family, **o: port_config(fam, **o), inp, mesh,
                                    lambda args, ins: args, lambda t: t)
                 for family, inp in inputs.items()}
        reference = {family: _reference_steps(family, jparams[family], inputs[family])
                     for family in FAMILIES}
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * 5, [p.exitcode for p in procs]
    with open(d / "out.pkl", "rb") as f:
        sharded = pickle.load(f)
    with open(d / "one.pkl", "rb") as f:
        one_rank = pickle.load(f)
    return sharded, plain, reference, one_rank


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k).replace("['", ".").replace("']", "").strip("."): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_train_step_equals_plain_and_reference(family, runs):
    sharded, plain, reference, _ = runs
    (metrics, params), (pmetrics, pparams) = sharded[family]["train"], plain[family]["train"]
    jmetrics, jparams = reference[family]["train"]
    assert sorted(metrics) == sorted(pmetrics) == sorted(jmetrics) == ["aux", "ce", "grad_norm", "loss", "lr"]
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], pmetrics[k], **TOL, err_msg=f"{k} against plain")
        np.testing.assert_allclose(metrics[k], jmetrics[k], **TOL, err_msg=f"{k} against the reference")
    jflat = _flat(jparams)
    assert sorted(n.removeprefix(".") for n in params) == sorted(jflat)
    for name, layers in params.items():
        for got, want in zip(layers, pparams[name]):
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"{name} against plain")
        want = jflat[name.removeprefix(".")]
        np.testing.assert_allclose(np.stack(layers) if len(layers) > 1 or want.ndim > layers[0].ndim
                                   else layers[0], want, **TOL, err_msg=f"{name} against the reference")


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_serving_step_equals_plain_and_reference(family, step, runs):
    _check_serving(family, step, runs)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_decode_of_one_row_splits_the_cache_length_over_data(family, runs):
    from repro_torch.launch import specs as S

    cfg = port_config(family)
    mesh = AbstractMesh(*MESH)
    for name, spec in S.cache_spec_tree(cfg, mesh, S.cache_abstract(cfg, 1, CACHE)).items():
        if name in ("k", "v", "shared_k", "shared_v"):
            assert tuple(spec)[2] == "data", (name, spec)  # the flash-decoding split
    _check_serving(family, "decode_b1", runs)


@pytest.mark.parametrize("family", ["moe_ep", "moe_tp"])
def test_moe_decode_group_spans_data_ranks_and_drops(family, runs):
    from repro_torch.distributed import make_rules

    cfg = port_config(family, capacity_factor=0.5)
    rules = make_rules(cfg, AbstractMesh(*MESH)).rules
    assert (rules["experts"], rules["d_expert"]) == (("model", None) if family == "moe_ep" else (None, "model"))
    b = dict((n, b) for n, b, _ in steps(family))["decode_drops"]
    capacity = max(1, int(cfg.moe.top_k * b / cfg.moe.n_experts * cfg.moe.capacity_factor))
    assert capacity * cfg.moe.n_experts < b * cfg.moe.top_k  # one group of b tokens cannot hold every choice
    assert b % MESH[0][0] == 0 and b // MESH[0][0] < min(cfg.moe.group_size, b)  # and spans the data ranks
    _check_serving(family, "decode_drops", runs)


@pytest.mark.parametrize("step", ["moe prefill", "hybrid decode"])
def test_one_rank_mesh_runs_the_plain_ops_bit_for_bit(step, runs):
    """On a (1, 1) mesh every placement fits to Replicate, and the sharded
    forms run the plain code's ops on whole tensors."""
    sharded, plain = runs[3][step]
    assert sharded.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(sharded, plain), float((sharded.float() - plain.float()).abs().max())


def _check_serving(family: str, step: str, runs) -> None:
    sharded, plain, reference, _ = runs
    (logits, cache), (plogits, pcache) = sharded[family][step], plain[family][step]
    jlogits, jcache = reference[family][step]
    np.testing.assert_allclose(logits, plogits, **TOL, err_msg=f"{step} logits against plain")
    np.testing.assert_allclose(logits, np.asarray(jlogits), **TOL, err_msg=f"{step} logits against the reference")
    assert sorted(cache) == sorted(pcache) == sorted(jcache)
    for name in jcache:
        np.testing.assert_allclose(cache[name], pcache[name], **TOL, err_msg=f"{step} cache {name} against plain")
        np.testing.assert_allclose(cache[name], np.asarray(jcache[name]), **TOL,
                                   err_msg=f"{step} cache {name} against the reference")
