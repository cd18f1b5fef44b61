"""Faults planted under the timed path, which the check that decides
``correct`` has to catch: a step that returns its state unchanged, half of
the batch left out (the mean taken over the rest), and an answer altered
where it is produced (a scored batch's loss, a checkpoint's bytes).  One
chip runs each cell, so no cell has an exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

#: the faults each driver's cells can have
BY_DRIVER = {"score": ("half_batch", "answer_altered"),
             "train": ("unchanged_step", "half_batch", "answer_altered")}


def _half(fn):
    def call(params, cfg, batch):
        return fn(params, cfg, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return call


@contextlib.contextmanager
def planted(fault: str, driver: str):
    """The program with ``fault`` planted, for the cells of ``driver``."""
    from repro_torch import models
    from repro_torch.checkpoint import manager
    from repro_torch.training import loop
    from repro_torch.training.optimizer import OptState

    with contextlib.ExitStack() as stack:
        if fault == "half_batch":
            stack.enter_context(mock.patch.object(models, "train_loss", _half(models.train_loss)))
            stack.enter_context(mock.patch.object(loop, "train_loss", _half(loop.train_loss)))
        elif fault == "unchanged_step":
            def unchanged(grads, params, opt, hp):
                return params, OptState(opt.master, opt.m, opt.v, opt.step + 1), {
                    "grad_norm": opt.step.float() * 0, "lr": opt.step.float() * 0}
            stack.enter_context(mock.patch.object(loop, "adamw_step", unchanged))
        elif fault == "answer_altered" and driver == "score":
            score = models.train_loss

            def altered(params, cfg, batch):
                loss, metrics = score(params, cfg, batch)
                return loss * 1.01, metrics
            stack.enter_context(mock.patch.object(models, "train_loss", altered))
        elif fault == "answer_altered" and driver == "train":
            encode = manager.encode_array

            def flipped(x):
                blob = bytearray(encode(x))
                blob[-1] ^= 1
                return bytes(blob)
            stack.enter_context(mock.patch.object(manager, "encode_array", flipped))
        else:
            raise ValueError(f"no fault {fault!r} for the {driver} driver")
        yield
