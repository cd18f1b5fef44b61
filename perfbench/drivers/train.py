"""Closed-loop training into the FDB: the program's ``Trainer`` over an
emulated DAOS FDB, with asynchronous checkpoints of the whole train state.

Set-up builds one ``Trainer``, gives it the benchmark's weights and the
benchmark's traffic (through the program's own prefetch pipeline), and runs
it through the first checkpoint cycle: the first steps, which the reference
follows, and the cycle's save, so that the window finds every kernel built
and the save path warm.  That set-up checkpoint is wiped.  The window is
the same trainer under a run name of its own (so it starts without a
restore) for a fixed number of whole checkpoint cycles, ``--seconds`` over
the mix's nominal ``cycle_s`` (the same work in every run, whatever the
host's speed); it ends once the last checkpoint is published.

Checked once the window has closed: the first steps' losses, the first
gradient as the optimizer got it (its first moment after one step) and each
leaf's change after the reference's steps, against the plain reference; and
one checkpoint of the window, drawn from the seed, read back through the
FDB with each leaf's digest as it was when saved.  The window's own steps
are checked for finite losses only.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from perfbench import harness, tracing, weights
from perfbench.traffic import TokenStream

RULE_SHARE = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is left out of the change
DIGEST_PIECE = 1 << 24  # elements a digest takes at a time, which bounds its scratch memory


def digest(t: torch.Tensor) -> torch.Tensor:
    """One tensor's bits as unsigned integers, each times an odd weight that
    grows with its position, summed modulo 2**64 (int64 arithmetic wraps, and
    the sum is exact whatever its order).  Two tensors of 2- or 4-byte
    elements that differ in one element, or by two elements swapped, differ
    here: a change of b at place i moves the sum by b (2i + 1), and a swap by
    2 (b_i - b_j)(j - i), neither of which 2**64 divides."""
    ints = {2: (torch.int16, 0xFFFF), 4: (torch.int32, 0xFFFFFFFF), 8: (torch.int64, -1)}
    kind, mask = ints[t.element_size()]
    bits = t.detach().contiguous().view(kind).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, bits.numel(), DIGEST_PIECE):
        piece = bits[lo:lo + DIGEST_PIECE].to(torch.int64) & mask
        weight = torch.arange(lo, lo + piece.numel(), dtype=torch.int64, device=t.device) * 2 + 1
        total += (piece * weight).sum()
    return total


def fingerprint(state) -> torch.Tensor:
    """Each tensor's :func:`digest`, in tree order, on the tensors' device,
    without a wait."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(digest(node))
    walk(state)
    return torch.stack(out)


def relative_gap(program: dict, reference: dict, names) -> float:
    """The worst leaf's gap between the two sides' norms, over the reference
    leaf's norm or the median leaf's, whichever is larger."""
    floor = statistics.median(reference.values())
    return max(abs(program[n] - reference[n]) / max(reference[n], floor) for n in names)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: each first step's loss, the first gradient and
    the change after the steps, the last two by the worst leaf."""
    floor = statistics.median(ref["first_grad"].values())
    moved = [n for n, g in ref["first_grad"].items() if g >= RULE_SHARE * floor]
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": relative_gap(prog["first_grad"], ref["first_grad"], ref["first_grad"]),
            "change_gap": relative_gap(prog["change"], ref["change"], moved)}


class Job:
    """One trainer with the benchmark's weights and traffic."""

    def __init__(self, cell: harness.Cell):
        from repro_torch import models
        from repro_torch.configs import TrainConfig
        from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb
        from repro_torch.core.daos import DaosEngine
        from repro_torch.training import Trainer

        self.cell, mix = cell, cell.mix
        self.cfg = harness.port_config(cell)
        self.ref = harness.load_module("reference", cell.config["family"], cell.folder)
        self.shapes = self.ref.param_shapes(cell.config)
        harness.check_layout(self.shapes, models.abstract_params(self.cfg).tree())
        o = mix["optimizer"]
        self.hp = TrainConfig(learning_rate=o["learning_rate"], warmup_steps=o["warmup_steps"],
                              total_steps=o["total_steps"], weight_decay=o["weight_decay"], b1=o["b1"],
                              b2=o["b2"], eps=o["eps"], grad_clip=o["grad_clip"],
                              checkpoint_every=mix["checkpoint_every"], async_checkpoint=True,
                              seed=cell.seed % 2**31)
        f = mix["fdb"]
        self.fdb = make_fdb(f["backend"], schema=CHECKPOINT_SCHEMA,
                            engine=DaosEngine(f["engines"], f["targets_per_engine"]))
        self.trainer = Trainer(self.cfg, self.hp, self.fdb, run="setup", global_batch=mix["batch"],
                               seq_len=mix["seq"], device=cell.device)
        self.trainer.pipeline.close()  # the program's own synthetic stream: the benchmark feeds its own

    def load_weights(self, seed: int) -> None:
        """The seed's weights and fresh optimizer state, at step 0, and the
        seed's traffic through a new prefetch pipeline of the program's."""
        from repro_torch import models
        from repro_torch.data import PrefetchPipeline
        from repro_torch.training import init_opt_state

        self.close_pipeline()
        self.trainer.ckpt.wipe_run()  # no earlier seed's checkpoint to resume from
        self.stream = TokenStream(self.cell.mix, self.cfg.vocab, seed)
        self.trainer.pipeline = PrefetchPipeline(self.stream)
        w = weights.make(self.shapes, seed, self.cell.device, getattr(torch, self.cfg.dtype))
        self.trainer.params = models.ModelParams.from_tree(w).requires_grad_(True)
        self.trainer.opt = init_opt_state(self.trainer.params.tree())
        self.trainer.step = 0

    def first_steps(self, seed: int) -> dict:
        """The reference's steps through the trainer's own call and feed: the
        losses, the first gradient as the optimizer got it, and each leaf's
        change in the float32 master copy after the last of them."""
        t, n = self.trainer, self.cell.mix["reference_steps"]
        losses = [loss for _, loss in t.train(1, log_every=1).losses]
        first_grad = {k: g / (1 - self.hp.b1) for k, g in self.ref.leaf_norms(t.opt.m).items()}
        losses += [loss for _, loss in t.train(n - 1, log_every=1).losses]
        start = weights.make(self.shapes, seed, self.cell.device, getattr(torch, self.cfg.dtype))
        named, before = self.ref.leaves(t.opt.master), self.ref.leaves(start)
        change = {k: math.sqrt(sum(float((a - b.float()).double().square().sum())
                                   for a, b in zip(ts, before[k]))) for k, ts in named.items()}
        return {"losses": losses, "first_grad": first_grad, "change": change}

    def reference(self, seed: int, quant=None) -> dict:
        """The plain reference over the same batches from the same weights."""
        w32 = weights.cast(weights.make(self.shapes, seed, self.cell.device,
                                        getattr(torch, self.cfg.dtype)), torch.float32)
        batches = []
        for step in range(self.cell.mix["reference_steps"]):
            b = self.stream.batch_for_step(step)
            batches.append((torch.from_numpy(b["tokens"]).to(self.cell.device),
                            torch.from_numpy(b["targets"]).to(self.cell.device)))
        return self.ref.train(w32, self.cell.config, batches, self.cell.mix["optimizer"], quant=quant)

    def free_state(self) -> None:
        self.trainer.params = None
        self.trainer.opt = None
        if torch.device(self.cell.device).type == "cuda":
            torch.cuda.empty_cache()

    def close_pipeline(self) -> None:
        self.trainer.pipeline.close()
        for th in self.trainer.pipeline._readers:
            th.join(timeout=10)

    def close(self) -> None:
        self.close_pipeline()
        self.fdb.close()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: harness.Cell) -> harness.Outcome:
    from repro_torch.checkpoint import CheckpointManager

    parts = {"import_s": time.perf_counter() - cell.t_start}
    t = time.perf_counter()
    job = Job(cell)
    job.load_weights(cell.seed)
    _sync(cell.device)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = job.first_steps(cell.seed)
    every, n_ref = cell.mix["checkpoint_every"], cell.mix["reference_steps"]
    if n_ref % every:  # on to the end of the first cycle, whose save warms the save path
        job.trainer.train(every - n_ref % every, log_every=1)
    parts["first_cycle_s"] = time.perf_counter() - t
    job.trainer.ckpt.wipe_run()
    cycles = max(1, int(cell.seconds // cell.mix["cycle_s"]))
    parts["cycles"] = cycles

    spans = tracing.Spans()
    trainer = job.trainer
    trainer.run = "window"
    trainer.ckpt = CheckpointManager(job.fdb, "window", async_mode=True)
    saved = {}
    save = trainer.ckpt.save

    def save_with_fingerprint(step, state, **kw):
        with spans("check.fingerprint"):
            saved[step] = fingerprint(state)
        with spans("ckpt.save"):
            return save(step, state, **kw)

    trainer.ckpt.save = save_with_fingerprint
    trainer.ckpt.close = spans.wrap("ckpt.drain", trainer.ckpt.close)
    trainer._train_step = spans.wrap("step", trainer._train_step)
    trainer.pipeline.get = spans.wrap("batch.get", trainer.pipeline.get)
    prof = tracing.start_device_trace() if cell.trace else None
    _sync(cell.device)
    w0, w0_ns = time.perf_counter(), time.time_ns()
    report = trainer.train(cycles * every, log_every=1)
    _sync(cell.device)
    w1, w1_ns = time.perf_counter(), time.time_ns()
    window_s = w1 - w0
    steps = cycles * every
    tokens = steps * cell.mix["batch"] * cell.mix["seq"]

    saves = [r for r in trainer.ckpt.timings if r["op"] == "save"]
    readings = {"config": cell.config, "mix": cell.mix, "window_s": window_s, "tokens": tokens,
                "step_s": [s for i, s in enumerate(report.step_s) if (i + 1) % every],
                "saves": saves, "trace": None}
    if prof is not None:
        prof.__exit__(None, None, None)
        readings["trace"] = tracing.reduce_trace(tracing.device_events(prof), (w0_ns, w1_ns), spans.items)
        del prof
    peak = torch.cuda.max_memory_allocated() if torch.device(cell.device).type == "cuda" else 0

    # one checkpoint of the window, drawn from the seed, read back through the FDB
    published = trainer.ckpt.available_steps()
    missing = len(set(saved) - set(published))
    pick = sorted(saved)[int(np.random.default_rng(np.random.SeedSequence([cell.seed, 3])).integers(len(saved)))]
    _, back = trainer.ckpt.restore({"params": trainer.params.tree(), "opt": trainer.opt}, step=pick)
    back, want = fingerprint(back), saved[pick].cpu()
    mismatched = int((back != want).sum()) if back.shape == want.shape else len(want)
    job.free_state()
    ref = job.reference(cell.seed)
    checks = compare(prog, ref)
    window_losses = [loss for _, loss in report.losses]
    checks.update(ckpt_mismatch=float(missing + mismatched),
                  nonfinite_losses=float(sum(not math.isfinite(x) for x in window_losses)))
    job.close()
    return harness.Outcome(end_to_end={"train_tokens_per_s": tokens / window_s}, window_start=w0,
                           attempted=steps, failed=report.restarts, checks=checks, memory_peak=peak,
                           readings=readings, setup_parts=parts)

