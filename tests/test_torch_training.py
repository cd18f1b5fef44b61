"""The port's train forward, loss, optimizer, data pipeline and Trainer on the
CPU, against the JAX package.

Both packages start from the same weights: the reference's ``init_params``
carried across by ``params_from_numpy``.  ``reduced`` dense ``nwp-100m`` and
ssm ``mamba2-370m`` in float32: ``train_loss`` within 1e-5, every
parameter's gradient against ``jax.grad`` within 1e-5, and a 5-step
``Trainer`` loss trajectory within 1e-4.  The cases of
``tests/test_training.py`` run against the port, and taking a gradient
through ``attn_impl="pallas"`` raises in the port as ``jax.grad`` raises in
the reference.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import CHECKPOINT_SCHEMA as J_CHECKPOINT_SCHEMA  # noqa: E402
from repro.core import make_fdb as jmake_fdb  # noqa: E402
from repro.core.daos import DaosEngine as JDaosEngine  # noqa: E402
from repro.models import forward_hidden as jforward_hidden  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import train_loss as jtrain_loss  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training.optimizer import adamw_step as jadamw_step  # noqa: E402
from repro.training.optimizer import init_opt_state as jinit_opt_state  # noqa: E402
from repro.training.optimizer import lr_schedule as jlr_schedule  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb  # noqa: E402
from repro_torch.core.daos import DaosEngine  # noqa: E402
from repro_torch.data import PrefetchPipeline, SyntheticLM  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.models import forward_hidden, params_from_numpy, train_loss  # noqa: E402
from repro_torch.training import Trainer, TrainReport  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    OptState,
    adamw_step,
    global_norm,
    init_opt_state,
    lr_schedule,
)

F32 = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["nwp-100m", "mamba2-370m"]


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def configs(arch, **over):
    return (dataclasses.replace(reduced(get_config(arch)), **over),
            dataclasses.replace(jreduced(jget_config(arch)), **over))


def converted(arch, seed=0, **over):
    """(port cfg, reference cfg, port params, reference params) from one draw."""
    cfg, jcfg = configs(arch, **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp)), jp


def token_batch(vocab, seed=0, b=2, s=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# forward, loss and gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_forward_hidden_and_train_loss_match_reference(arch, impl):
    cfg, jcfg, tp, jp = converted(arch, attn_impl=impl)
    jb, tb = both(token_batch(cfg.vocab))
    jh, jaux = jforward_hidden(jp, jcfg, jb["tokens"])
    th, taux = forward_hidden(tp, cfg, tb["tokens"])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    assert float(taux) == float(jaux) == 0.0
    jl, jm = jtrain_loss(jp, jcfg, jb)
    tl, tm = train_loss(tp, cfg, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **F32)


def test_chunked_ce_ignores_negative_targets_like_reference():
    cfg, jcfg, tp, jp = converted("nwp-100m")
    batch = token_batch(cfg.vocab, seed=1, b=3, s=21)  # 63 tokens: the 8 chunks pad
    batch["targets"][0, :5] = -1
    batch["targets"][2, -3:] = -1
    jb, tb = both(batch)
    np.testing.assert_allclose(float(train_loss(tp, cfg, tb)[0]), float(jtrain_loss(jp, jcfg, jb)[0]), **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "none"])
def test_gradients_match_jax_grad(arch, remat):
    cfg, jcfg, tp, jp = converted(arch, seed=1, remat=remat)
    jb, tb = both(token_batch(cfg.vocab, seed=2))
    jg = jax.grad(lambda p: jtrain_loss(p, jcfg, jb)[0])(jp)
    tp.requires_grad_(True)
    train_loss(tp, cfg, tb)[0].backward()
    for name, stacked in jg["blocks"].items():
        for i, bp in enumerate(tp["blocks"]):
            np.testing.assert_allclose(bp[name].grad.numpy(), np.asarray(stacked[i]), **F32,
                                       err_msg=f"blocks.{name}[{i}]")
    for name in jg:
        if name != "blocks":
            np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jg[name]), **F32, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_through_the_kernel_path_raise_as_in_reference(arch):
    """jax.grad through attn_impl="pallas" raises in the reference (neither
    Pallas kernel has a VJP); backward() raises in the port, and the forward
    still runs with trainable parameters."""
    cfg, jcfg, tp, jp = converted(arch, attn_impl="pallas")
    jb, tb = both(token_batch(cfg.vocab, b=1, s=32))
    with pytest.raises(Exception):
        jax.grad(lambda p: jtrain_loss(p, jcfg, jb)[0])(jp)
    tp.requires_grad_(True)
    loss, _ = train_loss(tp, cfg, tb)
    assert loss.requires_grad and np.isfinite(float(loss.detach()))
    with pytest.raises(NotImplementedError, match="no VJP"):
        loss.backward()


def test_params_are_frozen_until_a_trainer_asks():
    cfg, _, tp, _ = converted("mamba2-370m")
    assert not any(p.requires_grad for p in tp.parameters())
    assert tp.requires_grad_(True) is tp and all(p.requires_grad for p in tp.parameters())


# ---------------------------------------------------------------------------
# the optimizer (tests/test_training.py::TestOptimizer, and parity)
# ---------------------------------------------------------------------------

def hp(**over):
    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=40,
                checkpoint_every=5, async_checkpoint=False)
    base.update(over)
    return TrainConfig(**base), JTrainConfig(**base)


class TestOptimizer:
    def test_adamw_reduces_quadratic(self):
        w = {"w": torch.tensor([3.0, -2.0])}
        opt = init_opt_state(w)
        h, _ = hp(learning_rate=0.2, weight_decay=0.0, total_steps=100)
        for _ in range(60):
            g = {"w": 2 * w["w"]}
            w, opt, _ = adamw_step(g, w, opt, h)
        assert float(w["w"].abs().max()) < 0.4
        assert int(opt.step) == 60

    def test_lr_schedule_shape_and_values(self):
        h, jh = hp(learning_rate=1.0, warmup_steps=10, total_steps=100)
        steps = [0, 5, 10, 55, 100]
        lrs = [float(lr_schedule(torch.tensor(s, dtype=torch.int32), h)) for s in steps]
        assert lrs[0] < lrs[1] < lrs[2]           # warmup
        assert lrs[2] > lrs[3] > lrs[4]           # cosine decay
        assert lrs[4] >= 0.09                      # floor at 10%
        want = [float(jlr_schedule(jnp.asarray(s), jh)) for s in steps]
        np.testing.assert_allclose(lrs, want, rtol=1e-6)

    def test_grad_clip_applied(self):
        w = {"w": torch.zeros((4,))}
        opt = init_opt_state(w)
        h, _ = hp(grad_clip=1.0, learning_rate=1.0, weight_decay=0.0)
        _, _, m = adamw_step({"w": torch.full((4,), 100.0)}, w, opt, h)
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_master_does_not_alias_float32_params(self):
        w = {"w": torch.ones(3)}
        opt = init_opt_state(w)
        assert opt.master["w"].data_ptr() != w["w"].data_ptr()
        assert isinstance(opt, OptState) and opt.step.dtype == torch.int32

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_adamw_step_matches_reference_on_a_model_tree(self, dtype):
        """Layer lists count the stacked axis: every block leaf is decayed,
        as the reference decays its (L, ...) leaves; the top-level vector
        final_norm is not."""
        cfg, jcfg, tp, jp = converted("mamba2-370m", dtype=dtype)
        rng = np.random.default_rng(3)
        jgrads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape, dtype=np.float32))
                              .astype(a.dtype), jp)
        tgrads = params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads)).tree()
        h, jh = hp(weight_decay=0.1, grad_clip=0.5)
        ptree = tp.tree()
        opt = init_opt_state(ptree)
        jopt = jinit_opt_state(jp)
        for _ in range(3):
            ptree, opt, m = adamw_step(tgrads, ptree, opt, h)
            jp, jopt, jm = jadamw_step(jgrads, jp, jopt, jh)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        tol = F32 if dtype == "float32" else dict(atol=0, rtol=2 ** -7)
        for name, stacked in jopt.master["blocks"].items():
            for i in range(cfg.n_layers):
                np.testing.assert_allclose(opt.master["blocks"][i][name].numpy(),
                                           np.asarray(stacked[i]), **F32, err_msg=name)
                np.testing.assert_allclose(ptree["blocks"][i][name].float().numpy(),
                                           np.asarray(jp["blocks"][name][i], np.float32), **tol)
                assert ptree["blocks"][i][name].dtype == (
                    torch.float32 if name in ("A_log", "D_skip") else getattr(torch, dtype))
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(opt.master[name].numpy(), np.asarray(jopt.master[name]), **F32)
            np.testing.assert_allclose(opt.v[name].numpy(), np.asarray(jopt.v[name]), **F32)
        assert int(opt.step) == int(jopt.step) == 3

    def test_global_norm_over_layer_lists(self):
        tree = {"a": torch.ones(4), "blocks": [{"w": torch.full((2,), 2.0)} for _ in range(3)]}
        assert float(global_norm(tree)) == pytest.approx(np.sqrt(4 + 3 * 8))


# ---------------------------------------------------------------------------
# the data pipeline (tests/test_training.py::TestPipeline, carried by copy)
# ---------------------------------------------------------------------------

class TestPipeline:
    def test_determinism(self):
        src = SyntheticLM(vocab=64, seq_len=16, global_batch=4, seed=1)
        a = src.batch_for_step(7)
        b = src.batch_for_step(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = src.batch_for_step(8)
        assert not np.array_equal(a["tokens"], c["tokens"])

    def test_prefetch_in_order_access(self):
        src = SyntheticLM(vocab=64, seq_len=16, global_batch=4)
        pipe = PrefetchPipeline(src, n_readers=2, depth=3)
        try:
            for s in range(6):
                batch = pipe.get(s, timeout=10)
                np.testing.assert_array_equal(batch["tokens"], src.batch_for_step(s)["tokens"])
        finally:
            pipe.close()

    def test_straggler_does_not_stall(self):
        """One slow read (simulated straggler) must not block later steps."""
        src = SyntheticLM(vocab=64, seq_len=16, global_batch=4)
        pipe = PrefetchPipeline(src, n_readers=3, depth=3,
                                delay_injector=lambda step: 1.5 if step == 1 else 0.0)
        try:
            t0 = time.monotonic()
            for s in range(3):
                pipe.get(s, timeout=10)
            assert time.monotonic() - t0 < 6
        finally:
            pipe.close()

    def test_reset_to_replays(self):
        src = SyntheticLM(vocab=64, seq_len=16, global_batch=4)
        pipe = PrefetchPipeline(src, n_readers=2, depth=2)
        try:
            first = pipe.get(0, timeout=10)
            pipe.reset_to(0)
            again = pipe.get(0, timeout=10)
            np.testing.assert_array_equal(first["tokens"], again["tokens"])
        finally:
            pipe.close()


# ---------------------------------------------------------------------------
# the Trainer (tests/test_training.py::TestTrainer, and parity)
# ---------------------------------------------------------------------------

def tiny_cfg():
    return reduced(get_config("nwp-100m"), n_layers=2, d_model=32, n_heads=2,
                   n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def daos_fdb():
    return make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=DaosEngine())


def trainer(run="run0", cfg=None, fdb=None, **over):
    return Trainer(cfg or tiny_cfg(), hp(**over)[0], fdb or daos_fdb(), run=run,
                   global_batch=4, seq_len=32)


class TestTrainer:
    def test_loss_decreases(self):
        tr = trainer()
        rep = tr.train(30, log_every=5)
        assert rep.losses[0][1] > rep.losses[-1][1], rep.losses
        assert isinstance(rep, TrainReport) and len(rep.step_s) == 30
        tr.pipeline.close()

    def test_failure_restart_resumes_from_checkpoint(self):
        tr = trainer()
        rep = tr.train(20, fail_at=12, log_every=5)
        assert rep.restarts == 1
        # failed at 12, last ckpt at 10 -> replays 10..12; still ends at 20+
        assert rep.final_step >= 20
        tr.pipeline.close()

    @pytest.mark.parametrize("async_checkpoint", [False, True])
    def test_restart_is_bitwise_deterministic(self, async_checkpoint):
        """Same final loss with and without a mid-run failure."""
        t1 = trainer("d1", async_checkpoint=async_checkpoint)
        r1 = t1.train(16, log_every=1)
        t1.pipeline.close()
        t2 = trainer("d2", async_checkpoint=async_checkpoint)
        r2 = t2.train(16, fail_at=13, log_every=1)
        t2.pipeline.close()
        l1, l2 = dict(r1.losses), dict(r2.losses)
        common = sorted(set(l1) & set(l2))
        assert common
        # post-restart losses must match the uninterrupted run exactly
        assert l1[common[-1]] == l2[common[-1]]
        assert [r["step"] for r in t2.ckpt.timings if r["op"] == "restore"] == [10]

    def test_resume_across_trainer_instances(self):
        eng = DaosEngine()
        f1 = make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=eng)
        tr = trainer("persist", fdb=f1)
        tr.train(10, log_every=5)
        tr.pipeline.close()
        f2 = make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=eng)
        tr2 = trainer("persist", fdb=f2)
        assert tr2.resume_or_init() is True
        assert tr2.step == 10
        for a, b in zip(tr.params.parameters(), tr2.params.parameters()):
            assert torch.equal(a, b)
        tr2.pipeline.close()

    def test_entry_point_runs_on_the_card_unless_asked(self, monkeypatch):
        set_default_device("cuda")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="set_default_device\\('cpu'\\)"):
            trainer()
        tr = Trainer(tiny_cfg(), hp()[0], daos_fdb(), device="cpu")
        assert tr.device.type == "cpu"
        tr.pipeline.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_five_step_trajectory_matches_reference(arch):
    """Both trainers start from the same converted weights (resume_or_init
    initialises only when params is None) and read the same SyntheticLM."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=40, checkpoint_every=5,
              async_checkpoint=False)
    cfg, jcfg = configs(arch)
    jt = JTrainer(jcfg, JTrainConfig(**kw), jmake_fdb("daos", schema=J_CHECKPOINT_SCHEMA,
                                                        engine=JDaosEngine()),
                  global_batch=2, seq_len=32)
    jt.init_state()
    tt = Trainer(cfg, TrainConfig(**kw), daos_fdb(), global_batch=2, seq_len=32)
    tt.params = params_from_numpy(cfg, jax.tree.map(np.asarray, jt.params)).requires_grad_(True)
    tt.opt = init_opt_state(tt.params.tree())
    want = jt.train(5, log_every=1)
    got = tt.train(5, log_every=1)
    jt.pipeline.close()
    tt.pipeline.close()
    assert [s for s, _ in got.losses] == [s for s, _ in want.losses] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([x for _, x in got.losses], [x for _, x in want.losses],
                               atol=1e-4, rtol=1e-4)
    assert got.losses[-1][1] < got.losses[0][1]


def test_example_trains_on_the_cpu(tmp_path):
    """examples/train_lm_torch.py with a reduced config, one injected failure."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(repo / "examples" / "train_lm_torch.py"), "--device", "cpu",
         "--reduced", "--arch", "mamba2-370m", "--steps", "12", "--fail-at", "7",
         "--ckpt-every", "5", "--seq", "64"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(repo / "src")},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "done: 12 steps, 1 restart(s)" in out.stdout, out.stdout
    assert "checkpoints visible: [5, 10]" in out.stdout, out.stdout


def slow_writer(mgr, seconds):
    """Delay each checkpoint write of ``mgr`` on its writer thread."""
    write = mgr._write

    def slow(*args, **kw):
        time.sleep(seconds)
        return write(*args, **kw)

    mgr._write = slow


def test_resume_after_a_failure_waits_for_the_writer():
    """A failure one step after an async checkpoint whose write is still
    running resumes from that checkpoint, whatever the writer's speed: the
    writer outlives the simulated failure, and the trainer waits for it."""
    tt = Trainer(tiny_cfg(), hp(async_checkpoint=True)[0], daos_fdb(), global_batch=2, seq_len=16)
    slow_writer(tt.ckpt, 1.0)
    rep = tt.train(8, fail_at=6, log_every=1)
    tt.pipeline.close()
    assert rep.restarts == 1
    assert [s for s, _ in rep.losses] == [1, 2, 3, 4, 5, 6, 6, 7, 8]  # step 6 replayed from 5
    assert [(r["op"], r["step"]) for r in tt.ckpt.timings][:2] == [("save", 5), ("restore", 5)]


def test_failure_before_any_checkpoint_starts_over_where_reference_times_out():
    """Reference fact, pinned: after a failure with no checkpoint visible the
    reference's resume_or_init re-initialises but does not reset its
    prefetch pipeline to step 0, so the next batch never comes (TimeoutError,
    after 60 s; 2 s here).  The port starts over from step 0."""
    import functools

    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=40, checkpoint_every=5,
              async_checkpoint=False)
    jt = JTrainer(jreduced(jget_config("nwp-100m"), n_layers=1, d_model=32, n_heads=2,
                           n_kv_heads=2, head_dim=16, d_ff=64, vocab=64),
                  JTrainConfig(**kw), jmake_fdb("daos", schema=J_CHECKPOINT_SCHEMA,
                                                engine=JDaosEngine()),
                  global_batch=2, seq_len=16)
    jt.pipeline.get = functools.partial(jt.pipeline.get, timeout=2.0)
    with pytest.raises(TimeoutError, match="batch for step 0"):
        jt.train(6, fail_at=3, log_every=1)
    jt.pipeline.close()
    tt = Trainer(tiny_cfg(), TrainConfig(**kw), daos_fdb(), global_batch=2, seq_len=16)
    rep = tt.train(6, fail_at=3, log_every=1)
    tt.pipeline.close()
    assert rep.restarts == 1 and rep.final_step == 6
    assert [s for s, _ in rep.losses] == [1, 2, 3, 1, 2, 3, 4, 5, 6]
