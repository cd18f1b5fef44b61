"""Closed-loop scoring: held-out batches through the program's ``train_loss``
without a gradient, one after another, each batch's loss read to the host
before the next is sent.

Set-up makes the weights on the card from the seed, draws a pool of batches
from the seed into pinned host memory and scores the first batches, which
builds and loads the kernels.  The window cycles through the pool for
``--seconds``.  Once it has closed, the program's state is freed and the
plain reference scores a sample of the window's batches, drawn from the
seed: the widest gap between the program's loss and the reference's is the
number compared.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import harness, tracing, weights
from perfbench.traffic import TokenStream


def build(cell: harness.Cell):
    """The program's configuration and parameters (the benchmark's weights),
    the reference module, and the pool of batches in pinned host memory."""
    from repro_torch import models

    cfg = harness.port_config(cell)
    ref = harness.load_module("reference", cell.config["family"], cell.folder)
    shapes = ref.param_shapes(cell.config)
    harness.check_layout(shapes, models.abstract_params(cfg).tree())
    params = models.ModelParams.from_tree(weights.make(shapes, cell.seed, cell.device,
                                                       getattr(torch, cfg.dtype)))
    stream = TokenStream(cell.mix, cfg.vocab, cell.seed)
    pin = torch.device(cell.device).type == "cuda"
    pool = []
    for i in range(cell.mix["pool_batches"]):
        b = {k: torch.from_numpy(v) for k, v in stream.batch_for_step(i).items()}
        pool.append({k: v.pin_memory() if pin else v for k, v in b.items()})
    return cfg, params, ref, shapes, pool


def score(params, cfg, pool, i: int, device, spans=None) -> float:
    """Batch i of the stream (pool entry i mod its size) through the program:
    its mean loss, read to the host."""
    from repro_torch import models

    spans = spans or tracing.Spans()
    with spans("batch.h2d"):
        batch = {k: v.to(device, non_blocking=True) for k, v in pool[i % len(pool)].items()}
    with spans("step"), torch.no_grad():
        loss, _ = models.train_loss(params, cfg, batch)
    with spans("loss.read"):
        return float(loss)


def reference_losses(cell: harness.Cell, ref, shapes, pool, indices, quant=None) -> list[float]:
    """The reference's loss of each sampled batch, from the seed's weights
    made again and cast to float32."""
    w32 = weights.cast(weights.make(shapes, cell.seed, cell.device, getattr(torch, cell.config["dtype"])),
                       torch.float32)
    out = []
    for i in indices:
        b = pool[i % len(pool)]
        out.append(ref.loss(w32, cell.config, b["tokens"].to(cell.device), b["targets"].to(cell.device),
                            quant=quant))
    return out


def sample(cell: harness.Cell, attempted: int) -> list[int]:
    """The window's batches the reference checks, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([cell.seed, 2]))
    k = min(cell.mix["check_batches"], attempted)
    return sorted(int(i) for i in rng.choice(attempted, size=k, replace=False))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: harness.Cell) -> harness.Outcome:
    parts = {"import_s": time.perf_counter() - cell.t_start}
    t = time.perf_counter()
    cfg, params, ref, shapes, pool = build(cell)
    _sync(cell.device)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    score(params, cfg, pool, 0, cell.device)  # builds and loads the kernels
    parts["first_batch_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(1, cell.mix["warmup_batches"]):
        score(params, cfg, pool, i, cell.device)
    parts["warmup_s"] = time.perf_counter() - t

    spans = tracing.Spans()
    prof = tracing.start_device_trace() if cell.trace else None
    _sync(cell.device)
    w0, w0_ns = time.perf_counter(), time.time_ns()
    losses = []
    while time.perf_counter() - w0 < cell.seconds:
        losses.append(score(params, cfg, pool, len(losses), cell.device, spans))
    w1, w1_ns = time.perf_counter(), time.time_ns()
    window_s = w1 - w0
    tokens = len(losses) * cell.mix["batch"] * cell.mix["seq"]

    readings = {"config": cell.config, "mix": cell.mix, "window_s": window_s, "tokens": tokens,
                "trace": None}
    if prof is not None:
        prof.__exit__(None, None, None)
        readings["trace"] = tracing.reduce_trace(tracing.device_events(prof), (w0_ns, w1_ns), spans.items)
        del prof
    peak = torch.cuda.max_memory_allocated() if torch.device(cell.device).type == "cuda" else 0

    del params
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    picked = sample(cell, len(losses))
    expected = reference_losses(cell, ref, shapes, pool, picked)
    checks = {"loss_gap": max((abs(losses[i] - e) for i, e in zip(picked, expected)), default=math.inf),
              "nonfinite_losses": float(sum(not math.isfinite(x) for x in losses))}
    return harness.Outcome(end_to_end={"score_tokens_per_s": tokens / window_s}, window_start=w0,
                           attempted=len(losses), failed=0, checks=checks, memory_peak=peak,
                           readings=readings, setup_parts=parts)
