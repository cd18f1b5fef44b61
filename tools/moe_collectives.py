"""The collectives the sharded moe FFN makes, and their wire bytes a device,
on the fake production mesh: one layer's ``moe_ffn`` alone, no card needed.

    PYTHONPATH=src python tools/moe_collectives.py [--multi-pod]

For each (arch, shape) below it traces ``repro_torch.models.moe.moe_ffn``
as the dry run traces a step (:func:`repro_torch.launch.dryrun.fake_mesh`,
fake DTensors with the cell's placements: tokens over the batch axes as the
model's residual stream holds them, the expert weights by the cell's
rules), forward to the output's placements in the residual stream (the
partial sum completed) and, for a train shape, backward through the output
and the aux loss, and prints each phase's collectives by kind with their count
and wire bytes a device (the ring convention of
``repro_torch.roofline.analysis.wire_bytes``).  Beside them it prints what
an all-to-all dispatch and combine of the reference's GSPMD form would
move: each device's (groups, E, C, D) expert input and output, all but
its own share of the `model` axis, each way.

granite-moe-3b-a800m (40 experts, which 16 does not divide) shards each
expert's width over `model`; phi3.5-moe-42b-a6.6b (16 experts) shards the
experts.  Prints one line per cell and phase, then a JSON object of them.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

CELLS = (("granite-moe-3b-a800m", "train_4k"), ("granite-moe-3b-a800m", "decode_32k"),
         ("phi3.5-moe-42b-a6.6b", "train_4k"), ("phi3.5-moe-42b-a6.6b", "decode_32k"))


def trace(arch: str, shape_name: str, multi_pod: bool) -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import PartitionSpec as P
    from repro_torch.distributed.sharding import axis_rules, constrain, named_shardings
    from repro_torch.launch import specs as S
    from repro_torch.launch.dryrun import _Wire, _to_fake, fake_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.init import torch_dtype
    from repro_torch.models.moe import moe_ffn

    cfg, shape = get_config(arch), SHAPES[shape_name]
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    names = ("router", "w_gate", "w_up", "w_down")
    out = {"arch": arch, "shape": shape_name}
    with fake_mesh(make_production_mesh(multi_pod=multi_pod)) as mesh:
        rules = S.rules_for(cfg, mesh)
        block = S.param_specs(cfg, mesh, rules)["blocks"][0]
        x = torch.empty((b, s, cfg.d_model), dtype=torch_dtype(cfg.dtype), device="meta")
        weights = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                   for n, t in S.abstract_params(cfg).tree()["blocks"][0].items() if n in names}
        shardings = (named_shardings(P(S.batch_partition(mesh, b), None, None), mesh),
                     named_shardings({n: block[n] for n in names}, mesh))
        mode, (fx, fw) = _to_fake((x, weights), shardings, mesh)
        train = shape.kind == "train"
        with mode:
            for t in (fx, *fw.values()):
                t.requires_grad_(train)
            wire = _Wire()
            with wire, axis_rules(rules), torch.no_grad() if not train else torch.enable_grad():
                y, aux = moe_ffn(fx, fw, cfg.moe)
                y = constrain(y, "batch", "seq", "d_model")  # the output's partial sum completed
            out["forward"] = {"counts": dict(wire.counts), "wire_bytes": dict(wire.wire)}
            if train:
                wire = _Wire()
                with wire:
                    (y.float().sum() + aux).backward()
                out["backward"] = {"counts": dict(wire.counts), "wire_bytes": dict(wire.wire)}
    sizes = S.mesh_sizes(mesh)
    bp = S.batch_partition(mesh, b)
    rows = b // math.prod(sizes[a] for a in ((bp,) if isinstance(bp, str) else bp or ()))
    msize = sizes["model"]
    g = min(cfg.moe.group_size, b * s)
    cap = max(1, int(cfg.moe.top_k * g / cfg.moe.n_experts * cfg.moe.capacity_factor))
    groups = max(1, rows * s // g)  # a group that spans data ranks counts once
    slots = groups * cfg.moe.e_total * cap * cfg.d_model * torch.finfo(x.dtype).bits // 8
    out["all_to_all_model"] = 2 * slots * (msize - 1) / msize
    out["rules"] = {k: rules.rules[k] for k in ("experts", "d_expert")}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    recs = []
    for arch, shape in CELLS:
        rec = trace(arch, shape, args.multi_pod)
        recs.append(rec)
        for phase in ("forward", "backward"):
            if phase in rec:
                w = rec[phase]
                print(f"{arch} {shape} {rec['rules']} {phase}: "
                      + ", ".join(f"{op} x{w['counts'][op]} {w['wire_bytes'][op]:.4g} B"
                                  for op in sorted(w["counts"]))
                      + f"; total {sum(w['wire_bytes'].values()):.4g} B a device")
        print(f"{arch} {shape}: an all-to-all dispatch and combine over `model` would move "
              f"{rec['all_to_all_model']:.4g} B a device")
    print(json.dumps(recs))


if __name__ == "__main__":
    main()
