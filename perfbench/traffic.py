"""The one traffic generator: token batches from a mix's parameters and a seed.

Modelled on the port's ``SyntheticLM`` and written here, so that a change to
the program cannot change the traffic.  Batch ``step`` of stream ``stream``
is a pure function of (seed, stream, step): the same seed gives the same
tokens, and each step's rows differ.

Token ids follow the Zipf-Mandelbrot law of word frequencies, the frequency
of the r-th commonest being proportional to (r + offset) ** -exponent, and
id r - 1 is the r-th commonest: every seed draws from the same distribution.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    """Batches of ``batch`` rows of ``seq`` tokens and their next-token
    targets, drawn as the mix's ``tokens`` entry says."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        spec = mix["tokens"]
        if spec["distribution"] != "zipf_mandelbrot":
            raise ValueError(f"unknown token distribution {spec['distribution']!r}")
        self.vocab, self.seed = vocab, seed
        self.batch, self.seq = mix["batch"], mix["seq"]
        self.stream = spec["stream"]
        weight = (np.arange(1, vocab + 1, dtype=np.float64) + spec["offset"]) ** -spec["exponent"]
        self.cdf = np.cumsum(weight / weight.sum())
        self.cdf[-1] = 1.0

    def batch_for_step(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.stream, step]))
        toks = np.searchsorted(self.cdf, rng.random((self.batch, self.seq + 1)), side="right")
        toks = toks.astype(np.int32)  # ids in [0, vocab)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
