"""Batched serving engine: slot-based continuous batching over a shared KV
cache, the counterpart of ``repro.serving.engine``.

The decode loop always steps a FULL (B, 1) batch against the shared cache.
New requests are prefilled individually (batch=1) and their cache written
into a free slot mid-flight, so long generations never block admission
(continuous batching).  Completed slots free immediately.  Admission, EOS
and budget rules are the reference's (``engine.py:95-149``).  The engine
runs on the device its parameters live on, under ``torch.inference_mode``.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import CACHE_BATCH_AXIS, decode_step, init_cache, prefill
from ..models.init import ModelParams

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    rid: int = field(default_factory=itertools.count().__next__)
    # filled by the engine:
    generated: list[int] = field(default_factory=list)
    done: bool = False


def _insert_slot(batch_cache: dict, single_cache: dict, slot: int) -> dict:
    """Write a batch=1 cache into slot ``slot`` of the shared batch cache, in
    place.  Each entry's batch axis is named in ``CACHE_BATCH_AXIS``, where
    the reference guesses it from the shapes; ``pos`` stays host-managed."""
    for k, b in batch_cache.items():
        if k == "pos":
            continue
        b.narrow(CACHE_BATCH_AXIS[k], slot, 1).copy_(single_cache[k])
    return batch_cache


class ServeEngine:
    def __init__(self, params: ModelParams, cfg: ModelConfig, *, max_batch: int = 4,
                 cache_len: int = 256):
        self.params = params
        self.cfg = cfg
        self.device = params.device
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.cache = init_cache(cfg, max_batch, cache_len, device=self.device)
        # per-slot state (host side)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)         # next position per slot
        self.last_token = np.zeros((max_batch, 1), np.int32)
        self._queue: list[Request] = []
        self._done: list[Request] = []
        #: prefills and decode steps so far, their host-clock seconds (each
        #: ends in a read of its tokens, which waits for the card) and the
        #: tokens they added to requests
        self.stats = {"prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0}

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until queue + slots drain; returns completed requests."""
        with torch.inference_mode():
            for _ in range(max_steps):
                self._admit()
                if self.active == 0 and not self._queue:
                    break
                self._decode_once()
        return self._done

    # ------------------------------------------------------------- internals
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue.pop(0)
            plen = len(req.prompt)
            if plen + req.max_new_tokens > self.cache_len:
                raise ValueError(f"request {req.rid} exceeds cache_len")
            # batch=1 prefill, then graft into the shared cache at `slot`
            t0 = time.perf_counter()
            c1 = init_cache(self.cfg, 1, self.cache_len, device=self.device)
            tokens = torch.tensor(np.asarray(req.prompt, np.int32), device=self.device)
            logits, c1 = prefill(self.params, self.cfg, tokens[None, :], c1)
            nxt = int(torch.argmax(logits[0, : self.cfg.vocab]))  # waits for the card
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += plen
            _insert_slot(self.cache, c1, slot)
            self.slot_req[slot] = req
            self.slot_pos[slot] = plen
            self.last_token[slot, 0] = nxt
            req.generated.append(nxt)
            # the prefill itself may produce EOS (or exhaust the budget):
            # finish without occupying a decode slot
            if (req.eos_id is not None and nxt == req.eos_id) or req.max_new_tokens <= 1:
                req.done = True
                self._done.append(req)
                self.slot_req[slot] = None

    def _decode_once(self) -> None:
        if self.active == 0:
            return
        # decode_step takes PER-ROW positions: every active slot advances at
        # its own depth in one batched step; free slots re-write their stale
        # position, which the budget rule keeps below cache_len (a torch
        # index out of range raises where the reference's write is dropped)
        if int(self.slot_pos.max()) >= self.cache_len:
            raise RuntimeError(f"a slot position reached cache_len {self.cache_len}")
        t0 = time.perf_counter()
        self.cache["pos"] = torch.tensor(self.slot_pos, device=self.device)
        token = torch.tensor(self.last_token, device=self.device)
        logits, self.cache = decode_step(self.params, self.cfg, token, self.cache)
        toks = torch.argmax(logits[:, : self.cfg.vocab], dim=-1).tolist()  # waits for the card
        new_pos = self.cache["pos"].cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = toks[slot]
            self.slot_pos[slot] = new_pos[slot]
            budget_done = (
                len(req.generated) >= req.max_new_tokens
                or int(new_pos[slot]) >= self.cache_len - 1
            )
            eos_done = req.eos_id is not None and tok == req.eos_id
            if eos_done and not budget_done:
                # EOS is part of the output, matching the prefill-EOS path
                req.generated.append(tok)
                self.stats["decode_tokens"] += 1
            if budget_done or eos_done:
                req.done = True
                self._done.append(req)
                self.slot_req[slot] = None
            else:
                req.generated.append(tok)
                self.stats["decode_tokens"] += 1
                self.last_token[slot, 0] = tok
