"""The port's FDB-backed checkpointing on the CPU: the cases of
``tests/test_checkpoint.py`` (all but its mesh case, which needs a sharded
device mesh), and checkpoints written by either package restoring in the
other, bf16 included, through one POSIX root."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import make_fdb as jmake_fdb  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.training.optimizer import init_opt_state as jinit_opt_state  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    decode_array,
    encode_array,
    flatten_tree,
    unflatten_tree,
)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb  # noqa: E402
from repro_torch.core.daos import DaosEngine  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.training import OptState, init_opt_state  # noqa: E402


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def small_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn((8, 16), generator=g),
            "b": torch.zeros((16,), dtype=torch.bfloat16),
        },
        "opt": {"m": torch.ones((8, 16)), "step": torch.tensor(3, dtype=torch.int32)},
    }


def assert_trees_equal(a, b):
    fa, _ = flatten_tree(a)
    fb, _ = flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype and torch.equal(fa[name], fb[name]), name


@pytest.fixture(params=["daos", "posix"])
def fdb(request, tmp_path):
    if request.param == "daos":
        return make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=DaosEngine())
    return make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=str(tmp_path / "ckpt"))


class TestSerialization:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
    def test_roundtrip(self, dtype):
        x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4).to(dtype)
        back = decode_array(encode_array(x))
        assert back.shape == (2, 3, 4) and back.dtype == dtype
        assert torch.equal(back, x)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
    def test_fields_are_the_reference_fields(self, dtype):
        """Byte for byte the reference's RPR1 field, read back by either package."""
        from repro.checkpoint import decode_array as jdecode_array
        from repro.checkpoint import encode_array as jencode_array

        j = (jnp.arange(24, dtype=jnp.float32).reshape(2, 3, 4) - 7.25).astype(dtype)
        t = decode_array(jencode_array(j))
        assert encode_array(t) == jencode_array(j)
        np.testing.assert_array_equal(np.asarray(jdecode_array(encode_array(t)), np.float32),
                                      np.asarray(j, np.float32))

    def test_bad_magic_raises(self):
        with pytest.raises(ValueError, match="magic"):
            decode_array(b"XXXX" + encode_array(torch.ones(2))[4:])

    def test_layer_lists_are_stacked_under_reference_names(self):
        tree = {"params": {"blocks": [{"w": torch.full((2,), float(i))} for i in range(3)],
                           "embed": torch.ones(2, 2)},
                "opt": OptState({"x": torch.ones(1)}, {"x": torch.zeros(1)}, {"x": torch.zeros(1)},
                                torch.tensor(5, dtype=torch.int32))}
        leaves, manifest = flatten_tree(tree)
        assert sorted(leaves) == ["opt.m.x", "opt.master.x", "opt.step", "opt.v.x",
                                  "params.blocks.w", "params.embed"]
        assert leaves["params.blocks.w"].shape == (3, 2)
        assert manifest["names"] == list(leaves)
        back = unflatten_tree(tree, leaves)
        assert isinstance(back["opt"], OptState) and len(back["params"]["blocks"]) == 3
        assert_trees_equal(back, tree)
        with pytest.raises(KeyError, match="params.embed"):
            unflatten_tree(tree, {k: v for k, v in leaves.items() if k != "params.embed"})

    def test_snapshot_does_not_see_later_in_place_updates(self):
        w = torch.zeros(4)
        leaves, _ = flatten_tree({"w": w, "blocks": [{"v": w}]})
        w.add_(1)
        assert float(leaves["w"].sum()) == 0 and float(leaves["blocks.v"].sum()) == 0


class TestCheckpointManager:
    def test_save_restore_roundtrip(self, fdb):
        mgr = CheckpointManager(fdb, "runA", async_mode=False)
        state = small_state()
        mgr.save(10, state)
        step, restored = mgr.restore(state)
        assert step == 10
        assert_trees_equal(restored, state)

    def test_latest_step_selected(self, fdb):
        mgr = CheckpointManager(fdb, "runB", async_mode=False)
        s = small_state()
        for st in (5, 10, 15):
            mgr.save(st, s)
        assert mgr.available_steps() == [5, 10, 15]
        step, _ = mgr.restore(s)
        assert step == 15

    def test_async_mode_is_durable_after_wait(self, fdb):
        mgr = CheckpointManager(fdb, "runC", async_mode=True)
        s = small_state()
        mgr.save(1, s)
        mgr.save(2, s)
        mgr.wait()
        assert mgr.available_steps() == [1, 2]
        assert [(r["op"], r["step"]) for r in mgr.timings] == [("save", 1), ("save", 2)]
        assert all(r["bytes"] > 8 * 16 * 4 for r in mgr.timings)
        mgr.close()

    def test_no_torn_checkpoint_visible(self, tmp_path):
        """A reader polling during writes only ever sees complete steps."""
        fdb_w = make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=str(tmp_path / "c"))
        fdb_r = make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=str(tmp_path / "c"))
        w = CheckpointManager(fdb_w, "runT", async_mode=False)
        r = CheckpointManager(fdb_r, "runT", async_mode=False)
        s = small_state()
        seen = []
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                for st in r.available_steps():
                    try:
                        r.restore(s, step=st)
                    except FileNotFoundError as e:  # would be a torn manifest
                        seen.append(("torn", st, str(e)))

        t = threading.Thread(target=poll)
        t.start()
        for st in range(1, 6):
            w.save(st, s)
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        torn = [x for x in seen if x[0] == "torn"]
        assert not torn, f"reader observed torn checkpoints: {torn[:3]}"

    def test_replacement_same_step(self, fdb):
        mgr = CheckpointManager(fdb, "runR", async_mode=False)
        s1 = small_state(seed=1)
        s2 = small_state(seed=2)
        mgr.save(7, s1)
        mgr.save(7, s2)
        _, restored = mgr.restore(s1, step=7)
        assert torch.equal(restored["params"]["w"], s2["params"]["w"])

    def test_wipe_run(self, fdb):
        mgr = CheckpointManager(fdb, "runW", async_mode=False)
        mgr.save(1, small_state())
        mgr.wipe_run()
        assert mgr.available_steps() == []

    def test_close_stops_background_machinery(self, fdb):
        with CheckpointManager(fdb, "runX", async_mode=True) as mgr:
            mgr.save(1, small_state())
        # context exit drained the queue and stopped the writer threads;
        # the caller's FDB stays usable
        mgr2 = CheckpointManager(fdb, "runX", async_mode=False)
        assert mgr2.available_steps() == [1]
        mgr2.close()

    def test_restore_onto_a_device(self, fdb):
        mgr = CheckpointManager(fdb, "runD", async_mode=False)
        mgr.save(1, small_state())
        _, restored = mgr.restore(small_state(), device="cpu")
        assert restored["params"]["w"].device.type == "cpu"
        assert mgr.timings[-1]["op"] == "restore" and mgr.timings[-1]["step"] == 1


# ---------------------------------------------------------------------------
# across packages: a trainer's state, bf16 parameters and float32 optimizer
# ---------------------------------------------------------------------------

def trainer_states(dtype):
    """The same trainer state in both packages: reduced mamba2-370m's
    parameters (bf16 or float32, A_log and D_skip float32) and optimizer."""
    jcfg = jreduced(jget_config("mamba2-370m"), dtype=dtype)
    cfg = reduced(get_config("mamba2-370m"), dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(5))
    jstate = {"params": jp, "opt": jinit_opt_state(jp)}
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    tstate = {"params": tp.tree(), "opt": init_opt_state(tp.tree())}
    return jstate, tstate


def assert_same_state(tstate, jstate):
    leaves, _ = flatten_tree(tstate)
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    assert len(flat) == len(leaves)
    for path, leaf in flat:
        name = jax.tree_util.keystr(path).replace("'", "").replace("[", ".").replace("]", "").strip(".")
        t = leaves[name]
        assert str(t.dtype).split(".")[1] == np.asarray(leaf).dtype.name, name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32), err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    jstate, tstate = trainer_states(dtype)
    root = str(tmp_path / "x")
    CheckpointManager(make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=root), "run",
                      async_mode=False).save(4, tstate)
    jmgr = JCheckpointManager(jmake_fdb("posix", schema="checkpoint", root=root), "run", async_mode=False)
    step, restored = jmgr.restore(jstate)
    assert step == 4
    assert_same_state(tstate, restored)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    jstate, tstate = trainer_states(dtype)
    jstate = jax.tree.map(lambda a: a + jnp.ones((), a.dtype), jstate)  # not the template's values
    root = str(tmp_path / "y")
    JCheckpointManager(jmake_fdb("posix", schema="checkpoint", root=root), "run",
                       async_mode=False).save(9, jstate)
    mgr = CheckpointManager(make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=root), "run",
                            async_mode=False)
    step, restored = mgr.restore(tstate)
    assert step == 9
    assert isinstance(restored["opt"], OptState)
    assert len(restored["params"]["blocks"]) == len(tstate["params"]["blocks"])
    assert_same_state(restored, jstate)
