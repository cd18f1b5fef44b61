"""The port's ``distributed/`` (logical-axis rules, ZeRO-1 specs, DTensor
placements), ``models/scan.py``, ``logical_axes``/``abstract_params`` and
the sharded checkpoint restore, held against the reference on the CPU.

Meshes stand in for devices where only names and sizes are read: the
reference's ``make_rules`` and ``zero_shard_spec`` read ``axis_names`` and
``devices.shape`` of their mesh, the port's ``mesh_dim_names`` and
``shape``.  The DTensor cases spawn gloo ranks on the CPU, rendezvous
through a ``FileStore`` under the test's ``tmp_path``."""

import dataclasses
import datetime
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    AbstractMesh,
    AxisRules,
    NamedSharding,
    PartitionSpec,
    axis_rules,
    constrain,
    current_rules,
    logical_to_spec,
    make_rules,
    named_shardings,
    zero_shard_spec,
    zero_shard_tree,
)
from repro_torch.models import abstract_params, logical_axes  # noqa: E402
from repro_torch.models.scan import layer_scan, maybe_cond  # noqa: E402

MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"), (4, 2): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def ref_mesh(shape, names):
    """What the reference's make_rules and zero_shard_spec read of a mesh."""
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def batch_axes(names) -> tuple[str, ...]:
    """As ``repro/launch/specs.py::rules_for``: the batch over (pod, data)."""
    return tuple(a for a in ("pod", "data") if a in names) or ("data",)


# ------------------------------------------------------------------ make_rules
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_make_rules_equals_reference(arch, shape):
    from repro.configs import get_config as jget_config
    from repro.distributed.sharding import make_rules as jmake_rules

    names = MESHES[shape]
    ours = make_rules(get_config(arch), AbstractMesh(shape, names), batch_axes=batch_axes(names))
    theirs = jmake_rules(jget_config(arch), ref_mesh(shape, names), batch_axes=batch_axes(names))
    assert ours.rules == theirs.rules


def test_make_rules_without_a_mesh_replicates_every_model_axis():
    rules = make_rules(get_config("qwen2.5-3b"), None)
    assert {k: v for k, v in rules.rules.items() if v is not None} == {"batch": "data"}
    assert rules.spec("batch", None, "heads") == PartitionSpec("data", None, None)
    with pytest.raises(ValueError, match="no mesh"):
        rules.sharding("batch")


def test_axis_rules_are_thread_local_and_nest():
    import threading

    outer, inner = AxisRules({"a": "data"}), AxisRules({"a": "model"})
    seen = []
    with axis_rules(outer):
        with axis_rules(inner):
            t = threading.Thread(target=lambda: seen.append(current_rules()))
            t.start()
            t.join()
            assert current_rules() is inner
        assert current_rules() is outer
    assert current_rules() is None and seen == [None]


# ------------------------------------------------------------- zero_shard_spec
def test_zero_shard_spec_asserts_of_the_reference():
    """The three asserts of ``tests/test_properties.py:174-182``."""
    P = PartitionSpec
    mesh = AbstractMesh((4, 2), ("data", "model"))
    assert zero_shard_spec(P(None, "model"), (16, 8), mesh) == P("data", "model")
    assert zero_shard_spec(P("model", None), (64, 3), mesh) == P(("model", "data"), None)
    assert zero_shard_spec(P(None,), (3,), mesh) == P(None,)
    # data = 1: the spec is unchanged (test_zero_shard_spec_preserves_validity)
    assert zero_shard_spec(P(None, None), (8, 16), AbstractMesh((1,), ("data",))) == P(None, None)


@pytest.mark.parametrize("seed", range(6))
def test_zero_shard_spec_equals_reference_on_random_cases(seed):
    from jax.sharding import PartitionSpec as JP

    from repro.distributed.zero import zero_shard_spec as jzero_shard_spec

    rng = np.random.default_rng(seed)
    for _ in range(60):
        names = ("pod", "data", "model") if rng.random() < 0.3 else ("data", "model")
        shape = tuple(int(rng.choice([1, 2, 4, 8, 16])) for _ in names)
        dims = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 16, 48, 64])) for _ in range(rng.integers(1, 4)))
        choices = [None, "model", "pod" if "pod" in names else None]
        parts = [choices[rng.integers(len(choices))] for _ in range(rng.integers(0, len(dims) + 1))]
        axis = "data" if rng.random() < 0.8 else "absent"
        ours = zero_shard_spec(PartitionSpec(*parts), dims, AbstractMesh(shape, names), axis)
        theirs = jzero_shard_spec(JP(*parts), dims, ref_mesh(shape, names), axis)
        assert tuple(ours) == tuple(theirs), (names, shape, dims, parts, axis)
        assert isinstance(ours, PartitionSpec)


def test_zero_shard_tree_follows_the_port_tree():
    cfg = get_config("mamba2-370m")
    mesh = AbstractMesh((4, 2), ("data", "model"))
    rules = make_rules(cfg, mesh)
    pspecs = logical_to_spec(logical_axes(cfg), rules)
    zspecs = zero_shard_tree(pspecs, abstract_params(cfg).tree(), mesh)
    assert len(zspecs["blocks"]) == cfg.n_layers
    # out_proj (d_inner, d_model): d_inner on model, d_model gains data
    assert pspecs["blocks"][0]["out_proj"] == PartitionSpec("model", None)
    assert zspecs["blocks"][0]["out_proj"] == PartitionSpec(("model", "data"), None)
    assert zspecs["embed"] == PartitionSpec(("model", "data"), None)


# --------------------------------------------------- logical_axes, abstract_params
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_axes_and_abstract_params_equal_reference(arch):
    from repro.configs import get_config as jget_config
    from repro.models import abstract_params as jabstract_params
    from repro.models import logical_axes as jlogical_axes

    cfg = get_config(arch)
    axes, params = logical_axes(cfg), abstract_params(cfg).tree()
    jaxes, jparams = jlogical_axes(jget_config(arch)), jabstract_params(jget_config(arch))
    assert sorted(axes) == sorted(jaxes) == sorted(params) == sorted(jparams)
    for part in jaxes:
        if isinstance(params[part], list):  # a layer list: the reference stacks it
            assert len(params[part]) == len(axes[part]) == jparams[part][next(iter(jparams[part]))].shape[0]
            layers = zip(axes[part], params[part])
            strip = 1
        else:
            layers = [(axes[part], params[part])]
            strip = 0
        for layer_axes, layer in layers:
            flat = layer if isinstance(layer, dict) else {None: layer}
            ref_flat = jparams[part] if isinstance(jparams[part], dict) else {None: jparams[part]}
            ref_axes = jaxes[part] if isinstance(jaxes[part], dict) else {None: jaxes[part]}
            names = layer_axes if isinstance(layer_axes, dict) else {None: layer_axes}
            assert sorted(flat, key=str) == sorted(ref_flat, key=str) == sorted(names, key=str)
            for name, t in flat.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(ref_flat[name].shape[strip:]), (part, name)
                assert str(t.dtype).removeprefix("torch.") == str(ref_flat[name].dtype), (part, name)
                assert names[name] == tuple(ref_axes[name][strip:]), (part, name)
                assert len(names[name]) == t.ndim, (part, name)
                if strip:
                    assert ref_axes[name][0] == "layers"


def test_abstract_params_allocates_nothing_and_makes_real_ones():
    cfg = get_config("internvl2-76b")
    params = abstract_params(cfg)
    n = sum(p.numel() for p in params.parameters())
    assert n > 70e9 and all(p.is_meta for p in params.parameters())
    small = dataclasses.replace(reduced(get_config("zamba2-7b")), dtype="bfloat16")
    real = abstract_params(small).to_empty(device="cpu")
    assert real.blocks[0]["A_log"].dtype == torch.float32 and real.embed.dtype == torch.bfloat16


# -------------------------------------------------------- layer_scan, maybe_cond
def _scan_inputs(seed=0, layers=5, width=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, width)).astype(np.float32),
            {"w": (rng.standard_normal((layers, width, width)) / np.sqrt(width)).astype(np.float32),
             "b": rng.standard_normal((layers, width)).astype(np.float32)})


@pytest.mark.parametrize("unroll", [False, True])
def test_layer_scan_and_maybe_cond_equal_reference(unroll):
    import jax.numpy as jnp

    from repro.models.scan import layer_scan as jlayer_scan
    from repro.models.scan import maybe_cond as jmaybe_cond

    h0, xs = _scan_inputs()
    n = xs["w"].shape[0]

    def body(lib, cond, tanh):
        def step(h, x):
            p, i = x
            h = tanh(h @ p["w"] + p["b"])
            h = cond(i % 2 == 0, lambda v: 2 * v, lambda v: v - 1, h)
            return h, {"sum": h.sum(-1), "first": h[:, 0]}
        return step

    jh, jys = jlayer_scan(body(jnp, jmaybe_cond, jnp.tanh), jnp.asarray(h0),
                          ({k: jnp.asarray(v) for k, v in xs.items()}, jnp.arange(n)), unroll=unroll)
    t = {k: torch.from_numpy(v) for k, v in xs.items()}
    for layer_xs in ((t, torch.arange(n)),  # stacked leaves, a tensor of indices
                     ([{k: v[i] for k, v in t.items()} for i in range(n)], list(range(n)))):
        h, ys = layer_scan(body(torch, maybe_cond, torch.tanh), torch.from_numpy(h0), layer_xs,
                           unroll=unroll)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        for k in ("sum", "first"):
            assert tuple(ys[k].shape) == tuple(jys[k].shape)
            np.testing.assert_allclose(ys[k].numpy(), np.asarray(jys[k]), rtol=1e-5, atol=1e-5)


def test_layer_scan_without_ys_and_with_a_length():
    h, ys = layer_scan(lambda c, x: (c + x, None), torch.zeros(()), torch.arange(6.0), length=4)
    assert ys is None and float(h) == 0 + 1 + 2 + 3
    h, ys = layer_scan(lambda c, x: (c, None), torch.zeros(()), [])
    assert ys is None and float(h) == 0


@pytest.mark.parametrize("pred", [True, np.bool_(True), torch.tensor(True), torch.tensor(1)])
def test_maybe_cond_takes_concrete_predicates(pred):
    assert maybe_cond(pred, lambda v: v + 1, lambda v: v - 1, 10) == 11
    assert maybe_cond(not bool(pred), lambda v: v + 1, lambda v: v - 1, 10) == 9


def test_maybe_cond_refuses_a_predicate_that_is_not_scalar():
    with pytest.raises(ValueError, match="scalar"):
        maybe_cond(torch.tensor([True, False]), lambda v: v, lambda v: v, 0)


# ------------------------------------------------------------ specs, placements
def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2), ("data", "model"))
    P = PartitionSpec
    assert NamedSharding(mesh, P("data", "model")).placements(2) == (Shard(0), Shard(1))
    assert NamedSharding(mesh, P("model")).placements(3) == (Replicate(), Shard(0))
    assert NamedSharding(mesh, P()).placements(0) == (Replicate(), Replicate())
    # a composite dimension is split in the mesh's order, whatever the spec's
    assert NamedSharding(mesh, P(("model", "data"), None)).placements(2) == (Shard(0), Shard(0))
    assert NamedSharding(mesh, P(("data", "model"), None)).placements(2) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="not axes"):
        NamedSharding(mesh, P("pod")).placements(1)
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, P("data", "data")).placements(2)
    with pytest.raises(ValueError, match="entries"):
        NamedSharding(mesh, P(None, None, "data")).placements(2)


def test_logical_to_spec_and_named_shardings_keep_the_tree():
    cfg = reduced(get_config("zamba2-7b"))
    mesh = AbstractMesh((1, 2), ("data", "model"))
    specs = logical_to_spec(logical_axes(cfg), make_rules(cfg, mesh))
    shard = named_shardings(specs, mesh)
    assert isinstance(specs["blocks"], list) and len(shard["blocks"]) == cfg.n_layers
    assert isinstance(shard["shared"]["wq"], NamedSharding)
    assert shard["embed"].spec == specs["embed"] == PartitionSpec("model", None)


def test_constrain_leaves_a_plain_tensor_alone_under_rules():
    x = torch.ones(2, 3)
    rules = make_rules(get_config("qwen2.5-3b"), AbstractMesh((2, 2), ("data", "model")))
    with axis_rules(rules):
        assert constrain(x, "batch", "d_model") is x
        with pytest.raises(ValueError, match="rank"):
            constrain(x, "batch")
    assert constrain(x, "batch", "d_model") is x


# ----------------------------------------------------------- spawned gloo ranks
def _init(rank: int, world: int, store: str) -> None:
    set_default_device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))


def _constrain_worker(rank: int, world: int, store: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    _init(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        full = torch.arange(24.0).reshape(4, 6)
        x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
        rules = make_rules(get_config("qwen2.5-3b"), mesh)
        assert constrain(x, "batch", "d_model") is x  # no rules active: unchanged
        with axis_rules(rules):
            y = constrain(x, "batch", "d_model")
        assert y.placements == (Shard(0), Replicate()), y.placements
        assert torch.equal(y.to_local(), full[2 * rank: 2 * rank + 2])
        assert torch.equal(y.full_tensor(), full)
    finally:
        dist.destroy_process_group()


def test_constrain_redistributes_a_dtensor_under_active_rules(tmp_path):
    mp.start_processes(_constrain_worker, args=(2, str(tmp_path / "store")), nprocs=2,
                       start_method="spawn")


def _elastic_worker(rank: int, world: int, store: str, root: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb
    from repro_torch.models import init_params, train_loss
    from repro_torch.training.optimizer import OptState, init_opt_state
    from repro_torch.tree import leaf_groups, tree_map

    _init(rank, world, store)
    try:
        P = PartitionSpec
        mesh_a = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mesh_b = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
        w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
        layers = [torch.full((8, 4), float(i)) for i in range(3)]

        def on(mesh, spec, t):
            return distribute_tensor(t, mesh, NamedSharding(mesh, spec).placements(t.ndim))

        # a ZeRO-composed spec: dim 0 over ("model", "data") is split in the
        # mesh's order, data outer: rank (d, m) holds chunk 2 d + m
        zspec = zero_shard_spec(P("model", None), (64, 32), mesh_a)
        assert zspec == P(("model", "data"), None)
        z = on(mesh_a, zspec, w)
        d, m = mesh_a.get_coordinate()
        assert torch.equal(z.to_local(), w.chunk(4)[2 * d + m])
        state = {"w": on(mesh_a, P("data", "model"), w), "z": z,
                 "blocks": [{"k": on(mesh_a, P(None, "model"), t)} for t in layers]}

        fdb = make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=root)
        mgr = CheckpointManager(fdb, "elastic", async_mode=True)
        mgr.save(1, state)  # gathers on every rank; rank 0 writes
        mgr.wait()  # the barrier: rank 0's write is durable everywhere
        assert mgr.available_steps() == [1]

        # elastic restore onto a different mesh shape and placements; the
        # shardings mirror the template's layer list, not the stored stack
        template = {"w": w, "z": w, "blocks": [{"k": t} for t in layers]}
        shardings = {"w": NamedSharding(mesh_b, P("model", "data")),
                     "z": NamedSharding(mesh_b, P("data")),
                     "blocks": [{"k": NamedSharding(mesh_b, P(None, "data"))} for _ in layers]}
        step, got = mgr.restore(template, shardings=shardings)
        assert step == 1
        for name, group, _ in leaf_groups(got):
            for t in group:
                assert isinstance(t, DTensor) and t.device_mesh == mesh_b, name
        assert got["w"].placements == (Shard(1), Shard(0))
        assert torch.equal(got["w"].full_tensor(), w)
        assert torch.equal(got["z"].to_local(), w.chunk(4)[rank])
        for t, ref in zip(got["blocks"], layers):
            assert torch.equal(t["k"].full_tensor(), ref)
            assert torch.equal(t["k"].to_local(), ref[:, rank: rank + 1])
        with pytest.raises(ValueError, match="not both"):
            mgr.restore(template, device="cpu", shardings=shardings)

        # a train state saved unsharded, restored sharded with the rules of a
        # (2, 2) mesh: parameters by logical axes, optimizer state by ZeRO-1
        cfg = dataclasses.replace(reduced(get_config("mamba2-370m")), dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        train = {"params": params.tree(), "opt": init_opt_state(params.tree())}
        if rank == 0:  # plain tensors: one rank writes
            mgr.save(2, train)
            mgr.wait()
        dist.barrier()
        rules = make_rules(cfg, mesh_a)
        abstract = abstract_params(cfg).tree()
        pspecs = logical_to_spec(logical_axes(cfg), rules)
        zspecs = zero_shard_tree(pspecs, abstract, mesh_a)
        specs = {"params": pspecs, "opt": OptState(zspecs, zspecs, zspecs, P())}
        tmpl = {"params": abstract, "opt": OptState(abstract, abstract, abstract, None)}
        step, got = mgr.restore(tmpl, step=2, shardings=named_shardings(specs, mesh_a))
        want = dict((n, g) for n, g, _ in leaf_groups(train))
        spec_of = dict((n, g) for n, g, _ in leaf_groups(named_shardings(specs, mesh_a)))
        sharded = 0
        for name, group, _ in leaf_groups(got):
            for t, ref, s in zip(group, want[name], spec_of[name]):
                assert t.placements == s.placements(t.ndim), name
                assert torch.equal(t.full_tensor(), ref.detach()), name
                sharded += any(isinstance(p, Shard) for p in t.placements)
        assert sharded > 0
        full = tree_map(lambda t: t.full_tensor(), got["params"])
        restored = abstract_params(cfg).to_empty(device="cpu")
        restored.copy_from(full)
        batch = {"tokens": torch.arange(32).reshape(2, 16) % cfg.vocab,
                 "targets": (torch.arange(32).reshape(2, 16) + 1) % cfg.vocab}
        with torch.no_grad():
            assert float(train_loss(restored, cfg, batch)[0]) == float(train_loss(params, cfg, batch)[0])
        mgr.close()
    finally:
        dist.destroy_process_group()


def test_elastic_restore_across_mesh_shapes(tmp_path):
    """``tests/test_checkpoint.py::test_elastic_restore_across_mesh_shapes`` on
    four gloo ranks: saved sharded on a (2, 2) mesh into a POSIX FDB,
    restored onto (4, 1) with other placements; then a train state restored
    with the specs of make_rules, logical_axes and zero_shard_tree."""
    mp.start_processes(_elastic_worker, args=(4, str(tmp_path / "store"), str(tmp_path / "fdb")),
                       nprocs=4, start_method="spawn")
