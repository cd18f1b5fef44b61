"""The port's ``launch/`` (meshes, specs, step builders, the dry run) and
``roofline/probes.py``, held against the JAX package on the CPU.

- The specs (``batch_partition``, ``cache_spec_tree``, the batches' and
  prefill inputs' specs, ``opt_specs``) equal the reference's for every
  assigned arch, every shape and both production meshes, at published
  widths.  The reference reads a mesh only through ``axis_names`` and
  ``devices.shape``, so a stand-in serves; its abstract caches and
  parameters are shapes only.
- ``build_train_step``, ``build_prefill`` and ``build_decode`` on a (1, 1)
  mesh against the reference's on a 1x1 JAX mesh, for the dense, ssm, moe
  and hybrid families at ``reduced()`` in float32, parameters carried from
  the reference's ``init_params``: loss, metrics, updated parameters, logits
  and every cache entry within 1e-4.
- ``run_cell`` writes a record with the reference's keys and
  ``model_flops``; the probes equal the direct count for a homogeneous
  stack; a ``--attn-impl pallas`` trace calls the flash-attention operator
  once per attention site and never its plain version; a cell the
  reference skips is skipped.

Every process group (gloo for the real mesh, PyTorch's fake backend for the
dry run) is made in a spawned process."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import ASSIGNED  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.distributed import AbstractMesh, PartitionSpec  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes  # noqa: E402
from repro_torch.tree import leaf_groups  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {"dense": "qwen2.5-3b", "ssm": "mamba2-370m", "moe": "granite-moe-3b-a800m",
            "hybrid": "zamba2-7b"}
B, S0, CACHE = 2, 16, 32  # batch, prompt (and train) tokens, decode cache length
# Adam's first step is lr * g / (|g| + eps); eps = 1 keeps it linear in the
# gradient, so the updated parameters hold the gradients to the tolerance
HP = dict(learning_rate=1.0, warmup_steps=1, eps=1.0)


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def stand_in(mesh: AbstractMesh):
    """What the reference's specs read of a mesh."""
    import types

    return types.SimpleNamespace(axis_names=mesh.mesh_dim_names, devices=np.empty(mesh.shape))


def spec(p) -> tuple:
    return tuple(p)


def port_specs(tree, prefix: str = "") -> list[tuple[str, list, bool]]:
    """The port's tree of PartitionSpecs as (name, specs, stacked), a layer
    list's key once with its per-layer specs (``leaf_groups`` for specs)."""
    if isinstance(tree, PartitionSpec):
        return [(prefix, [tree], False)]
    if isinstance(tree, list):
        return [(f"{prefix}.{k}".strip("."), [layer[k] for layer in tree], True) for k in sorted(tree[0])]
    return [g for k in sorted(tree) for g in port_specs(tree[k], f"{prefix}.{k}".strip("."))]


def flat_specs(tree) -> dict:
    """A reference tree of PartitionSpecs by dotted leaf name."""
    from jax.sharding import PartitionSpec as JP

    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda v: isinstance(v, JP))[0]
    return {jax.tree_util.keystr(k).replace("['", ".").replace("']", "").strip("."): v
            for k, v in leaves}


# ----------------------------------------------------------------- the specs
def test_production_meshes_are_names_and_sizes():
    assert mesh_axis_sizes(make_production_mesh()) == {"data": 16, "model": 16}
    assert mesh_axis_sizes(make_production_mesh(multi_pod=True)) == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_equal_reference(arch, multi_pod):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.distributed.zero import zero_shard_spec as jzero_shard_spec
    from repro.launch import specs as JS

    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = stand_in(mesh)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert S.batch_partition(mesh, shape.global_batch) == JS.batch_partition(jmesh, jshape.global_batch)
        batch, bspecs = S.train_batch_abstract(cfg, shape, mesh)
        jbatch, jbspecs = JS.train_batch_abstract(jcfg, jshape, jmesh)
        assert {k: spec(v) for k, v in bspecs.items()} == {k: spec(v) for k, v in jbspecs.items()}
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in batch.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jbatch.items()}
        inputs, ispec, _, espec = S.prefill_inputs_abstract(cfg, shape, mesh)
        jinputs, jispec, _, jespec = JS.prefill_inputs_abstract(jcfg, jshape, jmesh)
        assert spec(ispec) == spec(jispec) and tuple(inputs.shape) == tuple(jinputs.shape)
        assert {k: spec(v) for k, v in espec.items()} == {k: spec(v) for k, v in jespec.items()}
        enc = shape.seq_len if cfg.is_encoder_decoder else 0
        cache = S.cache_abstract(cfg, shape.global_batch, shape.seq_len, enc_len=enc)
        jcache = JS.cache_abstract(jcfg, jshape.global_batch, jshape.seq_len, enc_len=enc)
        assert {k: tuple(v.shape) for k, v in cache.items()} == {k: tuple(v.shape) for k, v in jcache.items()}
        assert all(v.device.type == "meta" for v in cache.values())
        cspecs = S.cache_spec_tree(cfg, mesh, cache)
        jcspecs = JS.cache_spec_tree(jcfg, jmesh, jcache)
        assert {k: spec(v) for k, v in cspecs.items()} == {k: spec(v) for k, v in jcspecs.items()}, name

    # opt_specs: the reference stacks a layer list on a leading "layers" axis.
    # The port's per-layer spec is the reference's without that axis, except
    # where ZeRO put `data` on the layer axis: the port's per-layer leaf
    # takes it by the same rule on its own dims.
    opt = S.opt_specs(cfg, mesh, S.rules_for(cfg, mesh))
    jopt = JS.opt_specs(jcfg, jmesh, JS.rules_for(jcfg, jmesh))
    assert spec(opt.step) == spec(jopt.step) == ()
    jparams = JS.param_specs(jcfg, jmesh, JS.rules_for(jcfg, jmesh))
    shapes = {n: [tuple(t.shape) for t in g] for n, g, _ in leaf_groups(S.abstract_params(cfg).tree())}
    shapes = {n.strip("."): v for n, v in shapes.items()}
    groups = port_specs(opt.master)
    jflat, jpflat = flat_specs(jopt.master), flat_specs(jparams)
    assert sorted(name for name, _, _ in groups) == sorted(jflat)
    on_layers = 0
    for name, group, stacked in groups:
        key = name
        want = spec(jflat[key])
        if stacked and want[0] == "data":
            on_layers += 1
            per_layer = jzero_shard_spec(type(jpflat[key])(*spec(jpflat[key])[1:]), shapes[name][0], jmesh)
            want = spec(per_layer)
        elif stacked:
            want = want[1:]
        for s in group:
            assert isinstance(s, PartitionSpec) and spec(s) == want, (name, s, want)
    if get_config(arch).n_layers % 16 == 0:
        assert on_layers  # the case this test exists for is reached


# ------------------------------------------------------ the builders, (1, 1)
def _port_steps(arch: str, tree_path: str, out_path: str) -> None:
    """The three builders on a (1, 1) gloo mesh over the CPU: a spawned
    process, since it makes a process group."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, reduced
    from repro_torch.launch import build_decode, build_prefill, build_train_step, make_debug_mesh
    from repro_torch.models import init_cache, params_from_numpy, prefill
    from repro_torch.training.optimizer import init_opt_state

    set_default_device("cpu")
    with open(tree_path, "rb") as f:
        inp = pickle.load(f)
    cfg = reduced(get_config(arch))
    mesh = make_debug_mesh(device="cpu")
    out = {}
    try:
        for accum in inp["accums"]:
            params = params_from_numpy(cfg, inp["params"])
            hp = TrainConfig(grad_accum=accum, **HP)
            fn, *_ = build_train_step(cfg, hp, mesh, ShapeConfig("t", S0, B, "train"))
            params, opt, metrics = fn(params, init_opt_state(params.tree()),
                                      {k: torch.from_numpy(v) for k, v in inp["batch"].items()})
            out[f"train{accum}"] = ({k: float(v) for k, v in metrics.items()},
                                    {n: [t.detach().numpy().copy() for t in g]
                                     for n, g, _ in leaf_groups(params.tree())})
        params = params_from_numpy(cfg, inp["params"])
        fn, *_ = build_prefill(cfg, mesh, ShapeConfig("p", S0, B, "prefill"))
        with torch.no_grad():
            logits, cache = fn(params, torch.from_numpy(inp["prompt"]), init_cache(cfg, B, S0))
            out["prefill"] = (logits.numpy(), {k: v.numpy().copy() for k, v in cache.items()})
            fn, *_ = build_decode(cfg, mesh, ShapeConfig("d", CACHE, B, "decode"))
            _, cache = prefill(params, cfg, torch.from_numpy(inp["prompt"]), init_cache(cfg, B, CACHE))
            logits, cache = fn(params, torch.from_numpy(inp["token"]), cache)
            out["decode"] = (logits.numpy(), {k: v.numpy().copy() for k, v in cache.items()})
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _reference_steps(arch: str, jp, inp) -> dict:
    from repro.configs import get_config as jget_config, reduced as jreduced

    jcfg = jreduced(jget_config(arch))
    # Auto axes: the reference's constraints are shardings to propagate, as
    # in the JAX version it was written for (jax.make_mesh now defaults to
    # Explicit axes, where a constraint asserts)
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    with jax.set_mesh(mesh):
        return _reference_run(jcfg, mesh, jp, inp)


def _reference_run(jcfg, mesh, jp, inp) -> dict:
    from repro.configs import TrainConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch.steps import build_decode, build_prefill, build_train_step
    from repro.models import init_cache, prefill
    from repro.models.model import embed_inputs
    from repro.training.optimizer import init_opt_state

    out = {}
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    for accum in inp["accums"]:
        fn, *_ = build_train_step(jcfg, TrainConfig(grad_accum=accum, **HP), mesh,
                                  JShapeConfig("t", S0, B, "train"))
        params, _, metrics = jax.jit(fn)(jp, init_opt_state(jp), batch)
        out[f"train{accum}"] = ({k: float(v) for k, v in metrics.items()}, params)
    prompt = jnp.asarray(inp["prompt"])
    fn, *_ = build_prefill(jcfg, mesh, JShapeConfig("p", S0, B, "prefill"))
    out["prefill"] = jax.jit(fn)(jp, prompt, init_cache(jcfg, B, S0))
    fn, *_ = build_decode(jcfg, mesh, JShapeConfig("d", CACHE, B, "decode"))
    _, cache = jax.jit(lambda p, t, c: prefill(p, jcfg, t, c))(jp, prompt, init_cache(jcfg, B, CACHE))
    token = jnp.asarray(inp["token"])
    if "x0" in cache:
        # the reference's hybrid decode feeds its shared block the cached x0,
        # the previous token's embedding (a fault the port fixes); given the
        # current token's, it computes what the port computes
        cache = {**cache, "x0": embed_inputs(jp, jcfg, token)}
    out["decode"] = jax.jit(fn)(jp, token, cache)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_builders_equal_reference_on_a_one_device_mesh(family, tmp_path):
    from repro.configs import get_config as jget_config, reduced as jreduced
    from repro.models import init_params as jinit_params

    arch = FAMILIES[family]
    jcfg = jreduced(jget_config(arch))
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, S0 + 1)).astype(np.int32)
    inp = {"params": jax.tree.map(np.asarray, jp), "accums": (1, 2) if family == "dense" else (1,),
           "batch": {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()},
           "prompt": toks[:, :-1].copy(), "token": toks[:, -1:].copy()}
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_port_steps, args=(arch, str(tmp_path / "in.pkl"), str(tmp_path / "out.pkl")))
    p.start()
    p.join(timeout=300)
    assert p.exitcode == 0, p.exitcode
    with open(tmp_path / "out.pkl", "rb") as f:
        got = pickle.load(f)
    ref = _reference_steps(arch, jp, inp)

    for accum in inp["accums"]:
        metrics, params = got[f"train{accum}"]
        jmetrics, jparams = ref[f"train{accum}"]
        assert sorted(metrics) == sorted(jmetrics) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in jmetrics:
            np.testing.assert_allclose(metrics[k], jmetrics[k], **TOL, err_msg=f"{k}, accum {accum}")
        jflat = {jax.tree_util.keystr(k).replace("['", ".").replace("']", "").strip("."): np.asarray(v)
                 for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
        assert sorted(n.removeprefix(".") for n in params) == sorted(jflat)
        for name, layers in params.items():
            want = jflat[name.removeprefix(".")]
            np.testing.assert_allclose(np.stack(layers) if len(layers) > 1 or want.ndim > layers[0].ndim
                                       else layers[0], want, **TOL, err_msg=f"{name}, accum {accum}")
    for step in ("prefill", "decode"):
        (logits, cache), (jlogits, jcache) = got[step], ref[step]
        np.testing.assert_allclose(logits, np.asarray(jlogits), **TOL, err_msg=f"{step} logits")
        assert sorted(cache) == sorted(jcache)
        for name in jcache:
            np.testing.assert_allclose(cache[name], np.asarray(jcache[name]), **TOL,
                                       err_msg=f"{step} cache {name}")


# ------------------------------------------------------------------ the dry run
def _dry_run(out_dir: str, result_path: str) -> None:
    """run_cell, the probes and a pallas trace: a spawned process, since the
    dry run makes a fake process group."""
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import dryrun
    from repro_torch.roofline.probes import probe_corrected_costs

    res = {"record": dryrun.run_cell("qwen2.5-3b", "decode_32k", False, out_dir,
                                     overrides={"n_layers": 2})}
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), n_layers=3, dtype="bfloat16")
    train = ShapeConfig("t", 64, 8, "train")
    with dryrun.fake_mesh(AbstractMesh((2, 2), ("data", "model"))) as mesh:
        res["direct"] = dryrun.trace_cell(cfg, mesh, train)
        res["probes"] = probe_corrected_costs(cfg, mesh, train)
        plain = []
        fops.flash_attention_ref, real = (lambda *a, **k: plain.append(1)), fops.flash_attention_ref
        try:
            res["pallas"] = dryrun.trace_cell(dataclasses.replace(cfg, attn_impl="pallas"), mesh,
                                              ShapeConfig("p", 64, 8, "prefill"))
        finally:
            fops.flash_attention_ref = real
        res["plain_calls"] = len(plain)
    with open(result_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_dry_run, args=(str(d / "out"), str(d / "res.pkl")))
    p.start()
    p.join(timeout=600)
    assert p.exitcode == 0, p.exitcode
    with open(d / "res.pkl", "rb") as f:
        return pickle.load(f), d / "out"


#: the keys of a record the reference's run_cell writes (repro/launch/dryrun.py:112-129)
RECORD_KEYS = {"cell", "status", "arch", "shape", "mesh", "attn_impl", "chips", "lower_s",
               "compile_s", "memory", "cost_raw_scanned", "cost", "collectives_raw_scanned",
               "probes", "roofline"}


def test_run_cell_writes_the_reference_record(dry):
    import json

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.roofline.analysis import model_flops_for as jmodel_flops_for

    res, out = dry
    rec = res["record"]
    assert rec["status"] == "ok" and RECORD_KEYS <= set(rec)
    assert json.loads((out / "qwen2.5-3b__decode_32k__pod16x16.json").read_text())["cell"] == rec["cell"]
    assert rec["chips"] == 256 and rec["mesh"] == "pod16x16"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    jcfg = dataclasses.replace(jget_config("qwen2.5-3b"), n_layers=2)
    assert rec["roofline"]["model_flops"] == jmodel_flops_for(jcfg, JSHAPES["decode_32k"])
    assert rec["collectives_raw_scanned"]["total_bytes"] > 0  # the cache's length is split
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")


def test_probes_equal_the_direct_count_for_a_homogeneous_stack(dry):
    res, _ = dry
    direct, probes = res["direct"], res["probes"]
    assert probes["probe_a"] == 1
    for key in ("flops", "bytes", "coll_total"):
        assert probes[key] == pytest.approx(direct[key], rel=1e-12), key
    assert direct["flops"] > 0 and direct["coll_total"] > 0


def test_a_pallas_trace_calls_the_kernel_op_at_every_attention_site(dry):
    res, _ = dry
    assert res["pallas"]["ops"] == {"repro_torch::flash_attention": 3}
    assert res["plain_calls"] == 0


def test_cells_the_reference_skips_are_skipped(tmp_path):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro_torch.launch import dryrun

    # the reference's module sets XLA_FLAGS for 512 host devices when imported
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _skip_reason as jskip_reason
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags

    for arch in ASSIGNED:
        for name in SHAPES:
            ours = dryrun._skip_reason(get_config(arch), SHAPES[name])
            assert ours == jskip_reason(jget_config(arch), JSHAPES[name]), (arch, name)
    rec = dryrun.run_cell("qwen2.5-3b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "skipped" and (tmp_path / "qwen2.5-3b__long_500k__pod16x16.json").exists()


def test_launch_and_roofline_import_without_jax_or_repro():
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "flags = os.environ.get('XLA_FLAGS')\n"
        "import repro_torch.launch.mesh, repro_torch.launch.specs, repro_torch.launch.steps\n"
        "import repro_torch.launch.dryrun, repro_torch.roofline.analysis, repro_torch.roofline.probes\n"
        "from repro_torch.training.optimizer import abstract_opt_state\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert os.environ.get('XLA_FLAGS') == flags\n"
        "print('ok')\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_abstract_opt_state_is_float32_on_the_meta_device():
    from repro_torch.training.optimizer import abstract_opt_state

    cfg = get_config("mamba2-370m")
    params = S.abstract_params(cfg).tree()
    opt = abstract_opt_state(params)
    assert opt.step.dtype == torch.int32 and opt.step.shape == () and opt.step.device.type == "meta"
    for part in (opt.master, opt.m, opt.v):
        for (name, group, _), (_, pgroup, _) in zip(leaf_groups(part), leaf_groups(params)):
            for t, p in zip(group, pgroup):
                assert t.device.type == "meta" and t.dtype == torch.float32 and t.shape == p.shape, name
