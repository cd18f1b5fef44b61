"""Multi-pod dry run: trace every (arch × shape) cell on the production
meshes and count what one device computes, moves and holds.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA on 256 or 512 fake host devices and reads XLA's analyses.  The
port traces the step eagerly instead, on one process that plays rank 0 of a
fake process group of the mesh's size (PyTorch's ``fake`` backend over a
``FakeStore``: its collectives move nothing).  Parameters, optimizer state,
batch and cache enter as DTensors with the placements of the cell's
shardings (:mod:`.steps`), over fake tensors (``FakeTensorMode``) that hold
no storage, so a 512-card cell traces on one host's CPU.  The fake tensors carry
the CPU device: it is only a label for tensors without storage, and
PyTorch's autograd engine runs a backward through CUDA-labelled tensors only
in a CUDA build.  :class:`_Cost` counts each op as DTensor runs it, by its
shards on rank 0, and :class:`_Wire` the collectives DTensor makes:

- ``flops``: per device, by the formulas of ``torch.utils.flop_counter``
  (FlopCounterMode's registry; the flash-attention operator registers its
  own), each op's global count over the devices that share its work
  (:func:`_split`): an op replicated over a mesh axis counts in full on
  each of its devices.
- ``bytes accessed``: per device, every op's tensor inputs read once and
  outputs written once (its local shards); views move nothing, a gather
  reads what it writes and an in-place put writes its values.  Eager ops
  are not fused, so this exceeds what XLA's fused HLO reads and writes.
- collectives: per device, counted by ``CommDebugMode`` (``counts``) and
  converted from the local operand and result sizes to wire bytes by the
  reference's ring convention (:func:`repro_torch.roofline.analysis.wire_bytes`).
  On the CPU-labelled mesh DTensor turns an all-to-all into an all-gather
  and a chunk.
- memory: per device; ``argument_bytes`` and ``output_bytes`` are the local
  shards of the step's arguments and results, ``temp_bytes`` the most bytes
  of storage allocated during the step and alive at once (results included),
  ``peak_bytes`` their sum with the arguments.

Eager tracing runs every layer, so the counts are exact; the probes of
:mod:`repro_torch.roofline.probes` still trace the a- and 2a-layer variants
and reconstruct, and the record keeps both.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out artifacts/dryrun_torch]
"""

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["fake_mesh", "run_cell", "trace_cell"]


def _skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention arch: no sub-quadratic path for a 512k "
            "context (see DESIGN.md §shape-cell applicability)"
        )
    return None


def _parse_overrides(pairs) -> dict:
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` of ``mesh``'s axis names and sizes, this process its
    rank 0, over a fake process group of the mesh's size, for the duration
    of the block.  Refuses to replace a process group that exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group, and one exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(mesh.shape))
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape), mesh_dim_names=tuple(mesh.mesh_dim_names))
    finally:
        dist.destroy_process_group()


_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
_NO_DATA = ("empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like",
            "_unsafe_view")
# ops that touch only the indexed elements of their first input: a gather
# reads as many as it writes; an in-place put writes its values' worth
_GATHERS = ("index", "index_select", "gather", "embedding")
_PUTS = ("index_put_", "scatter_", "scatter_add_", "index_add_", "index_copy_")


def _flat_tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _flat_tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _flat_tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _split(out) -> int:
    """Over how many devices DTensor splits the work of an op with this
    output: the product of the mesh axes on which it is sharded or a
    partial sum (1 for a plain tensor; a replicated axis repeats the work)."""
    from torch.distributed.tensor import DTensor

    for t in _flat_tensors(out):
        if isinstance(t, DTensor):
            return math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                             if p.is_shard() or p.is_partial())
    return 1


class _Cost(TorchDispatchMode):
    """Counts the ops of one rank as DTensor runs them.  Each op is seen
    once, on DTensors of global shape: its flops (FlopCounterMode's formula
    on the global shapes) are divided by :func:`_split` of its output, and
    its bytes are those of its inputs' and outputs' local shards.  The
    storage of every new local output is followed until it is freed."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0
        self.ops = Counter()  # calls of operators outside aten, prim and the collectives
        self.live = 0
        self.peak = 0
        self.op = None  # the op in flight, which a failed cell's record names
        self._held: dict[int, weakref.finalize] = {}

    def _free(self, key: int, nbytes: int) -> None:
        self._held.pop(key, None)
        self.live -= nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) in self._held:
            return
        n = st.nbytes()
        self._held[id(st)] = weakref.finalize(st, self._free, id(st), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.op = str(func)
        out = func(*args, **kwargs)
        ns, name = func.name().split("::")
        name = name.split(".")[0]
        if ns not in ("aten", "prim", "_c10d_functional"):
            self.ops[func.name()] += 1
        if ns in ("_c10d_functional", "prim") or func.is_view or name in _NO_DATA:
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out) / _split(out)
        ins = [_local(t) for t in _flat_tensors((args, kwargs))]
        outs = [_local(t) for t in _flat_tensors(out)]
        if name in _GATHERS:
            self.bytes += sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
        elif name in _PUTS:
            self.bytes += 2 * sum(map(_nbytes, ins[1:]))
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            if not any(t.untyped_storage() is i.untyped_storage() for i in ins):
                self._allocated(t)
        return out


class _Wire(TorchDispatchMode):
    """Wire bytes of the collectives DTensor makes, from their local operand
    and result sizes: an op on DTensors is handed to DTensor
    (``NotImplemented``, as ``CommDebugMode`` does), whose collectives then
    come through this mode on local tensors."""

    def __init__(self):
        super().__init__()
        self.wire = Counter()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        from ..roofline.analysis import wire_bytes

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns, name = func.name().split("::")
        op = _COLLECTIVES.get(name.split(".")[0]) if ns == "_c10d_functional" else None
        if op is not None:
            ins = _flat_tensors((args, kwargs))
            outs = _flat_tensors(out)
            self.wire[op] += wire_bytes(op, sum(map(_nbytes, ins)), sum(map(_nbytes, outs)))
            self.counts[op] += 1
        return out


def _to_fake(args, shardings, mesh):
    """``args`` (meta tensors, a meta ModelParams) as fake DTensors with the
    placements of ``shardings``; returns (fake mode, fake args)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from ..distributed.sharding import NamedSharding, fit_placements
    from ..models import ModelParams
    from ..tree import tree_map

    def plan(t, sh):  # before the fake mode: local shapes are computed on real numbers
        placements = fit_placements(NamedSharding(mesh, sh.spec).placements(t.ndim), t.shape, mesh)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, placements)
        return t, placements, tuple(local)

    def fake(p):
        t, placements, local = p
        lt = torch.empty(local, dtype=t.dtype, device="cpu")
        return DTensor.from_local(lt, mesh, placements, run_check=False, shape=t.shape,
                                  stride=t.stride())

    is_plan = lambda v: isinstance(v, tuple) and len(v) == 3 and isinstance(v[0], torch.Tensor)  # noqa: E731
    trees = [a.tree() if isinstance(a, ModelParams) else a for a in args]
    plans = [tree_map(plan, a, s, is_leaf=lambda v: isinstance(v, torch.Tensor))
             for a, s in zip(trees, shardings)]
    mode = FakeTensorMode()
    with mode:
        out = []
        for a, p in zip(args, plans):
            tree = tree_map(fake, p, is_leaf=is_plan)
            out.append(ModelParams.from_tree(tree) if isinstance(a, ModelParams) else tree)
    return mode, out


def trace_cell(cfg, mesh, shape, hp=None) -> dict:
    """Build the cell's step on ``mesh`` (a ``DeviceMesh``, from
    :func:`fake_mesh` for a production mesh), trace it once on fake
    DTensors, and return its per-device counts.  A failure raises
    :class:`CellFailed`, naming the op in flight."""
    from torch.distributed.tensor.debug import CommDebugMode

    from .steps import build_cell

    fn, args, in_shardings, _, _ = build_cell(cfg, mesh, shape, hp=hp)
    fake_mode, fargs = _to_fake(args, in_shardings, mesh)
    cost, wire, comm = _Cost(), _Wire(), CommDebugMode()
    t0 = time.perf_counter()
    try:
        with fake_mode, comm, wire, cost:
            out = fn(*fargs)
    except Exception as e:
        raise CellFailed(cost.op, f"{type(e).__name__}: {e}") from e
    seconds = time.perf_counter() - t0
    argument = sum(_nbytes(_local(t)) for t in _flat_tensors(fargs))
    counts = {_COLLECTIVES.get(str(k).rsplit(".", 1)[-1], str(k)): v
              for k, v in comm.get_comm_counts().items()}
    if counts != dict(wire.counts):
        raise RuntimeError(f"CommDebugMode counted {counts}, the wire count {dict(wire.counts)}")
    return {
        "flops": float(cost.flops),
        "bytes": float(cost.bytes),
        "coll_total": float(sum(wire.wire.values())),
        "bytes_by_op": dict(wire.wire),
        "counts": counts,
        "ops": dict(cost.ops),
        "memory": {"argument_bytes": argument,
                   "output_bytes": sum(_nbytes(_local(t)) for t in _flat_tensors(out)),
                   "temp_bytes": cost.peak,
                   "peak_bytes": argument + cost.peak},
        "trace_s": seconds,
    }


class CellFailed(RuntimeError):
    """A cell's trace failed in ``op`` (the op in flight), with ``message``."""

    def __init__(self, op: str | None, message: str):
        super().__init__(op, message)
        self.op = op

    def __str__(self) -> str:
        return f"{self.op}: {self.args[1]}"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, attn_impl: str | None = None,
             overrides: dict | None = None, tag: str | None = None) -> dict:
    from ..configs import SHAPES, get_config
    from ..roofline.analysis import COLLECTIVES, model_flops_for, roofline
    from ..roofline.probes import probe_corrected_costs
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    hp = None
    if overrides:
        moe_over = {k[4:]: v for k, v in overrides.items() if k.startswith("moe.")}
        flat = {k: v for k, v in overrides.items() if not k.startswith("moe.")}
        if "grad_accum" in flat:
            from ..configs import TrainConfig

            hp = TrainConfig(grad_accum=flat.pop("grad_accum"))
        if moe_over:
            flat["moe"] = dataclasses.replace(cfg.moe, **moe_over)
        cfg = dataclasses.replace(cfg, **flat)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    if attn_impl:
        cell_id += f"__{attn_impl}"
    if tag:
        cell_id += f"__{tag}"

    reason = _skip_reason(cfg, shape)
    if reason:
        rec = {"cell": cell_id, "status": "skipped", "reason": reason}
        _write(out_dir, cell_id, rec)
        return rec

    amesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    try:
        with fake_mesh(amesh) as mesh:
            direct = trace_cell(cfg, mesh, shape, hp=hp)
            t_trace = time.perf_counter() - t0
            probes = probe_corrected_costs(cfg, mesh, shape, hp=hp)
    except CellFailed as e:
        rec = {"cell": cell_id, "status": "failed", "op": e.op, "error": str(e)[:2000]}
        _write(out_dir, cell_id, rec)
        return rec
    print(f"[{cell_id}] memory (per device):", direct["memory"])
    print(f"[{cell_id}] cost: flops={direct['flops']:.3e} bytes={direct['bytes']:.3e}")

    cost = {"flops": direct["flops"], "bytes accessed": direct["bytes"]}
    coll = {"total_bytes": direct["coll_total"],
            "bytes_by_op": {op: direct["bytes_by_op"].get(op, 0.0) for op in COLLECTIVES},
            "counts": direct["counts"]}
    rep = roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=math.prod(amesh.shape),
        cost=cost, collectives=coll, model_flops=model_flops_for(cfg, shape),
    )
    rec = {
        "cell": cell_id,
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "attn_impl": attn_impl or cfg.attn_impl,
        "chips": math.prod(amesh.shape),
        "lower_s": round(t_trace, 1),  # the trace: eager PyTorch compiles nothing
        "compile_s": 0.0,
        "memory": direct["memory"],
        "cost_raw_scanned": cost,
        "cost": cost,
        "collectives_raw_scanned": {"bytes_by_op": direct["bytes_by_op"], "counts": direct["counts"],
                                    "total_bytes": direct["coll_total"]},
        "probes": {k: v for k, v in probes.items() if k != "probe_raw"},
        "ops": direct["ops"],
        "roofline": rep.as_dict(),
    }
    _write(out_dir, cell_id, rec)
    return rec


def _write(out_dir: str, cell_id: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cell_id}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _sweep(args) -> int:
    """Run every cell in its own subprocess (a fresh fake process group each)."""
    from ..configs import ASSIGNED, SHAPES

    cells = [
        (arch, shape)
        for arch in (args.archs or ASSIGNED)
        for shape in (args.shapes or list(SHAPES))
    ]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for multi in meshes:
        for arch, shape in cells:
            mesh_name = "pod2x16x16" if multi else "pod16x16"
            cell_id = f"{arch}__{shape}__{mesh_name}"
            if args.attn_impl:
                cell_id += f"__{args.attn_impl}"
            path = os.path.join(args.out, f"{cell_id}.json")
            if os.path.exists(path) and not args.force:
                print(f"[skip existing] {cell_id}")
                continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--out", args.out,
            ]
            if multi:
                cmd.append("--multi-pod")
            if args.attn_impl:
                cmd += ["--attn-impl", args.attn_impl]
            print(f"=== {cell_id} ===", flush=True)
            r = subprocess.run(cmd, timeout=args.timeout)
            if r.returncode != 0:
                failures += 1
                if not os.path.exists(path):  # a failed trace writes its own record
                    _write(args.out, cell_id, {"cell": cell_id, "status": "failed", "rc": r.returncode})
    return failures


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", nargs="*")
    ap.add_argument("--shapes", nargs="*")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--override", action="append", default=None,
                    help="ModelConfig field override, e.g. --override seq_shard=true")
    ap.add_argument("--tag", default=None, help="artifact suffix for perf variants")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    if args.all or args.archs or args.shapes:
        sys.exit(_sweep(args))

    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.out, args.attn_impl,
                       overrides=_parse_overrides(args.override), tag=args.tag)
        print(json.dumps({k: v for k, v in rec.items() if k != "roofline"}, default=str))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    if rec["status"] == "failed":
        sys.exit(1)


if __name__ == "__main__":
    main()
