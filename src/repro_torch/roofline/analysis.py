"""Roofline terms of a traced dry-run cell, on the hardware model of one NVIDIA H100.

The port of ``repro.roofline.analysis``.  ``HW`` holds the card's peaks from
NVIDIA's data sheet for the H100 SXM part at its 700 W limit (dense rates,
no sparsity); the reference's table models a TPU chip and is not carried.
A card set below that limit runs slower under load; measured shares are
stated against these peaks with the card's limit beside them.

``link_bw`` is the collective term's rate: NVLink 4 *within one node* of 8
cards, 900 GB/s a card over its 18 links counting both directions, so
450 GB/s in each direction.  Wire bytes (below) are the bytes one card
sends, so they are divided by the one-direction rate.  The production
meshes of 256 and 512 cards span nodes, and their axes cross the
inter-node fabric, which is slower than NVLink (400 Gb/s a card with
InfiniBand NDR); ``collective_s`` is then a lower bound.

    compute_s    = flops / peak_flops
    memory_s     = bytes / hbm_bw
    collective_s = collective_wire_bytes / link_bw

Every count is per device: the dry run (:mod:`repro_torch.launch.dryrun`)
counts the operations of one rank's shards, so the per-device terms equal
the global formula (numerator and denominator both scale by ``chips``).
``model_flops`` alone is global.  Wire-byte convention per collective
(ring algorithms), as in the reference:

    all-reduce         2 × operand bytes
    all-gather         result bytes
    reduce-scatter     operand bytes
    all-to-all         operand bytes
    collective-permute operand bytes

:func:`parse_collectives` reads that convention off XLA's HLO text, as the
reference's does; the dry run counts the same ops from PyTorch's
collectives and converts them by the same rule (:func:`wire_bytes`).
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field

__all__ = ["COLLECTIVES", "HW", "RooflineReport", "model_flops_for", "parse_collectives",
           "roofline", "wire_bytes"]

HW = {
    "peak_flops": 989e12,  # bf16 dense on the tensor cores, operations/s
    "hbm_bw": 3.35e12,     # HBM3, bytes/s
    "f32_flops": 67e12,    # float32 outside the tensor cores, operations/s
    "link_bw": 450e9,      # NVLink 4 within a node, one direction, bytes/s a card
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b(pred|s8|u8|s16|u16|bf16|f16|f32|s32|u32|s64|u64|f64|c64|c128)\[([0-9,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s([\w\-]+)\(")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def wire_bytes(op: str, operand_bytes: int, result_bytes: int) -> int:
    """Bytes one device sends for one collective, by the ring convention above."""
    if op == "all-reduce":
        return 2 * operand_bytes
    if op == "all-gather":
        return result_bytes
    return operand_bytes


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Per-device wire bytes by collective op, from partitioned HLO text."""
    # symbol table: instruction name -> result bytes
    sizes: dict[str, int] = {}
    lines = hlo_text.splitlines()
    for ln in lines:
        m = _DEF_RE.match(ln)
        if m:
            name, type_str, _op = m.groups()
            sizes[name] = _type_bytes(type_str)

    wire = Counter()
    counts = Counter()
    for ln in lines:
        m = _DEF_RE.match(ln)
        if not m:
            continue
        name, type_str, op = m.groups()
        base = None
        for c in COLLECTIVES:
            if op == c or op == c + "-start":
                base = c
                break
        if base is None or op.endswith("-done"):
            continue
        # operand list: names inside the outermost parens
        paren = ln[ln.index(op) + len(op):]
        operand_names = re.findall(r"%?([\w.\-]+)(?:,|\))", paren.split("），")[0])
        operand_bytes = sum(sizes.get(n, 0) for n in operand_names if n in sizes)
        result_bytes = _type_bytes(type_str)
        if operand_bytes == 0:
            operand_bytes = result_bytes
        wire[base] += wire_bytes(base, operand_bytes, result_bytes)
        counts[base] += 1
    return {"bytes_by_op": dict(wire), "counts": dict(counts), "total_bytes": sum(wire.values())}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    collective_bytes: float     # per device wire bytes
    model_flops: float          # global useful FLOPs (6ND / 2ND)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str = ""
    useful_ratio: float = 0.0
    collectives: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def roofline(
    *,
    arch: str,
    shape: str,
    mesh: str,
    chips: int,
    cost: dict,
    collectives: dict,
    model_flops: float,
) -> RooflineReport:
    flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))
    coll_bytes = float(collectives.get("total_bytes", 0.0))
    compute_s = flops / HW["peak_flops"]
    memory_s = raw_bytes / HW["hbm_bw"]
    collective_s = coll_bytes / HW["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / max(flops * chips, 1.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=flops, hlo_bytes=raw_bytes, collective_bytes=coll_bytes,
        model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, useful_ratio=useful, collectives=collectives,
    )


def model_flops_for(cfg, shape) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train), 2·N_active·tokens (serve)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
