"""Trainer: the fault-tolerant training loop over the FDB storage plane.

- auto-resume: on start (or after a simulated node failure) the trainer
  restores the newest *visible* checkpoint — FDB's ACID flush means this is
  always a complete, untorn state;
- async checkpointing: the step loop hands snapshots to a writer thread;
- deterministic data: restart replays the exact token stream;
- straggler-tolerant input: work-stealing prefetch pool.

The port of ``repro.training.loop``.  A step is ``train_loss`` and
``backward()`` on the parameters (made trainable with ``requires_grad_``),
then :func:`adamw_step` in place.  Two differences from the reference, both
in the restart after an injected failure:

- the trainer waits for the checkpoints already handed to the writer
  before it restores.  The simulated failure loses device state, not the
  writer thread, which here outlives it; in the reference the resume point
  depends on how far the writer got;
- when no checkpoint is visible it starts over from step 0 with the data
  pipeline reset to step 0.  The reference re-initialises but leaves the
  pipeline where it was, so its next batch times out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig, TrainConfig
from ..core import FDBClient
from ..data.pipeline import PrefetchPipeline, SyntheticLM
from ..device import resolve_device
from ..models import init_params, train_loss
from ..tree import tree_map
from .optimizer import OptState, adamw_step, init_opt_state

__all__ = ["Trainer", "SimulatedFailure", "TrainReport"]


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclass
class TrainReport:
    steps_run: int
    final_step: int
    losses: list
    restarts: int
    wall_s: float
    #: host seconds of each step taken, from fetching its batch to the end of
    #: the optimizer update (a step that logs waits for its loss on the card)
    step_s: list = field(default_factory=list)


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        hp: TrainConfig,
        fdb: FDBClient,
        *,
        run: str = "run0",
        global_batch: int = 8,
        seq_len: int = 128,
        reader_delay=None,
        device=None,
    ):
        self.cfg = cfg
        self.hp = hp
        self.fdb = fdb
        self.run = run
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(fdb, run, async_mode=hp.async_checkpoint)
        self.source = SyntheticLM(cfg.vocab, seq_len, global_batch, seed=hp.seed)
        self.pipeline = PrefetchPipeline(self.source, delay_injector=reader_delay)
        self.params = None
        self.opt: OptState | None = None
        self.step = 0

    # ----------------------------------------------------------------- state
    def init_state(self) -> None:
        gen = torch.Generator(self.device).manual_seed(self.hp.seed)
        self.params = init_params(self.cfg, gen, device=self.device).requires_grad_(True)
        self.opt = init_opt_state(self.params.tree())
        self.step = 0

    def resume_or_init(self) -> bool:
        """True if resumed from a checkpoint."""
        if self.params is None:
            self.init_state()
        try:
            template = {"params": self.params.tree(), "opt": self.opt}
            step, state = self.ckpt.restore(template, device=self.params.device)
            self.params.copy_from(state["params"])
            self.opt = state["opt"]
            self.step = step
            self.pipeline.reset_to(step)
            return True
        except FileNotFoundError:
            # start over from self.step; the reference leaves the pipeline
            # where it was, and after a failure its next batch never comes
            self.pipeline.reset_to(self.step)
            return False

    def _train_step(self, batch: dict) -> dict:
        self.params.zero_grad(set_to_none=True)
        loss, metrics = train_loss(self.params, self.cfg, batch)
        loss.backward()
        ptree = self.params.tree()
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), ptree)
        _, self.opt, om = adamw_step(grads, ptree, self.opt, self.hp)
        self.params.zero_grad(set_to_none=True)
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}

    # ----------------------------------------------------------------- train
    def train(self, n_steps: int, *, fail_at: int | None = None, log_every: int = 10, max_restarts: int = 3) -> TrainReport:
        t0 = time.perf_counter()  # monotonic: wall_s must survive clock steps
        losses = []
        step_s = []
        restarts = 0
        self.resume_or_init()
        target = self.step + n_steps
        while self.step < target:
            try:
                while self.step < target:
                    t_step = time.perf_counter()
                    batch = self.pipeline.get(self.step)
                    batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                    if fail_at is not None and self.step == fail_at:
                        fail_at = None  # fail once
                        raise SimulatedFailure(f"injected failure at step {self.step}")
                    metrics = self._train_step(batch)
                    self.step += 1
                    if self.step % log_every == 0 or self.step == target:
                        loss = float(metrics["loss"])
                        losses.append((self.step, loss))
                        print(f"step {self.step:5d} loss {loss:.4f} lr {float(metrics['lr']):.2e}", flush=True)
                    step_s.append(time.perf_counter() - t_step)
                    if self.step % self.hp.checkpoint_every == 0:
                        self.ckpt.save(self.step, {"params": self.params.tree(), "opt": self.opt})
            except SimulatedFailure as e:
                restarts += 1
                if restarts > max_restarts:
                    raise
                print(f"!! {e} — restarting from last visible checkpoint", flush=True)
                self.ckpt.wait()  # the writer outlives the failure: let it publish
                self.params = None  # simulate losing device state
                self.opt = None
                self.resume_or_init()
        self.ckpt.close()  # drain + stop the background writer machinery
        return TrainReport(
            steps_run=n_steps, final_step=self.step, losses=losses,
            restarts=restarts, wall_s=time.perf_counter() - t0, step_s=step_s,
        )
