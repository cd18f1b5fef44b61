"""The per-layer gate that holds the split SSD-scan instance on a model's own inputs.

A scoring pass through a Mamba2 model calls the scan once per layer.  The
loss of the whole pass cannot tell a new summation order from a fault: on
trained mamba2-370m at full width (48 layers) the sound split instance moved
the held-out loss by 2.92e-4 from ``ssd_chunked``'s, a variant that only
rounds differently (each product from a zero accumulator) by 8.08e-4, and
the two faulty scans of :func:`faulty_scans` by 1.04e-3 and 1.83e-3
(``tools/ssd_scan_precision.py``, PERF.md).

:class:`LayerGate` stands in the wrapper's place for one pass and, at each
call, holds the wrapper's output against the plain version that rounds the
operands the split instance derives in float32 to the bf16 terms it feeds
them as (``ssd_scan_ref(..., split_bf16=True)``) on that call's inputs, at
:data:`SPLIT_TOL`: one bf16 ulp of the output plus float32 sums in another
order.  On the same inputs it runs each faulty scan, which must fail the
same tolerance on every layer with more than one chunk.  :func:`excess`
says by how much a call passes or fails: the largest difference over the
tolerance at that element, at most 1 within it.
"""

from __future__ import annotations

import torch

from .ops import flatten
from .ref import ssd_scan_ref

__all__ = ["SPLIT_TOL", "LayerGate", "excess", "faulty_scans", "plain_split"]

#: the split instance against the plain version with its operands split: one
#: bf16 ulp of the output (2^-7 relative at the bottom of a binade), plus
#: float32 sums in another order near zero
SPLIT_TOL = dict(atol=2e-3, rtol=8e-3)


def excess(got: torch.Tensor, want: torch.Tensor, tol: dict = SPLIT_TOL) -> float:
    """max |got - want| / (atol + rtol |want|) in float32: at most 1 where
    ``torch.testing.assert_close(got, want, **tol)`` passes (NaN counts as
    infinitely far)."""
    got, want = got.float(), want.float()
    ratio = (got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
    return float(torch.nan_to_num(ratio, nan=float("inf")).max()) if ratio.numel() else 0.0


def plain_split(x, dt, A, B_, C_, D_, *, chunk: int) -> torch.Tensor:
    """``ops.ssd_scan``'s contract, (B, S, H, P) in and out, through the plain
    version with the split instance's bf16 terms."""
    b, s, h, p = x.shape
    xf, dtf, af, df = flatten(x, dt, A, D_)
    out = ssd_scan_ref(xf, dtf, af, B_, C_, df, heads=h, chunk=chunk, split_bf16=True)
    return out.reshape(b, h, s, p).permute(0, 2, 1, 3)


def faulty_scans(scan) -> dict:
    """Stand-ins for the scan wrapper ``scan`` (``ops.ssd_scan``'s contract),
    each with one fault a hand-written scan could have: a gate must tell each
    from the sound scan."""
    def no_carry(x, dt, A, B_, C_, D_, *, chunk):
        # every chunk starts from a zero state: the inter-chunk term is lost
        b, s, h, p = x.shape
        q = min(chunk, s)

        def split(t):
            return t.reshape(b * (s // q), q, *t.shape[2:])
        return scan(split(x), split(dt), A, split(B_), split(C_), D_, chunk=q).reshape(x.shape)

    def next_head_decay(x, dt, A, B_, C_, D_, *, chunk):
        # each head decays at its neighbour's rate: a head index off by one
        return scan(x, dt, A.roll(1), B_, C_, D_, chunk=chunk)

    return {"no inter-chunk state": no_carry, "A of the next head": next_head_decay}


class LayerGate:
    """``scan`` (``ops.ssd_scan``'s contract) with each call held against
    ``plain`` on its own inputs, and ``faults`` (name -> scan) run on the same
    inputs; it returns ``scan``'s output, so a model pass through the gate
    is the pass through ``scan``.  :attr:`layers` keeps one record per call:
    its chunks and each scan's :func:`excess` over ``plain``."""

    def __init__(self, scan, faults: dict, plain=plain_split, tol: dict = SPLIT_TOL):
        self.scan, self.faults, self.plain, self.tol = scan, faults, plain, tol
        self.layers: list[dict] = []

    def __call__(self, x, dt, A, B_, C_, D_, *, chunk: int) -> torch.Tensor:
        out = self.scan(x, dt, A, B_, C_, D_, chunk=chunk)
        want = self.plain(x, dt, A, B_, C_, D_, chunk=chunk)
        s = x.shape[1]
        rec = {"chunks": s // min(chunk, s), "scan": excess(out, want, self.tol),
               "max_abs_err": float((out.float() - want.float()).abs().max())}
        for name, fault in self.faults.items():
            rec[name] = excess(fault(x, dt, A, B_, C_, D_, chunk=chunk), want, self.tol)
        self.layers.append(rec)
        return out

    def margin(self) -> tuple[float, int, str]:
        """The smallest excess of any fault on a layer with more than one
        chunk, with that layer's index and the fault's name."""
        return min(((rec[name], i, name) for i, rec in enumerate(self.layers) if rec["chunks"] > 1
                    for name in self.faults), default=(float("inf"), -1, ""))

    def check(self) -> None:
        """Raise unless the scan is within the tolerance on every layer and
        each fault outside it on every layer with more than one chunk."""
        assert self.layers, "the gate saw no call"
        worst = max(range(len(self.layers)), key=lambda i: self.layers[i]["scan"])
        assert self.layers[worst]["scan"] <= 1, (
            f"layer {worst}: the scan is {self.layers[worst]['scan']:.3g}x the tolerance {self.tol} "
            "from the plain version with split operands")
        ratio, layer, name = self.margin()
        assert ratio > 1, f"layer {layer}: the faulty scan {name!r} passes the gate ({ratio:.3g}x)"
