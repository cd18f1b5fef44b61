"""How precise the split SSD-scan instance must be for chip_smoke.py's scoring gate.

    python3 tools/ssd_scan_precision.py [--seed 0]

Needs one CUDA card and nvcc.  Trains mamba2-370m at full width for
chip_smoke.py's 6 steps (batch 8 x 2048, its TrainConfig and seed, without
the checkpoints and the injected failure; training is deterministic, so these
are the weights chip_smoke.py scores) and scores its held-out batch through:

- ``ssd_chunked``, the yardstick of the gate;
- ``ssd_scan_fwd`` on float32 copies of the bf16 inputs, cast back to bf16:
  what the bf16 instance at these shapes computed before the split instance;
- the float32 plain version, and the plain version with the operands the
  split instance derives rounded to two and to three bf16 terms;
- copies of ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu`` with the
  split instance changed by the textual edits of ``VARIANTS`` (each must match
  the source exactly once): two bf16 terms, and each wgmma of a launch
  (``ssd_chunk_state``'s, ``ssd_chunk_scan``'s) made from a zero accumulator
  and added in float32, which rounds otherwise but is not a fault; built into ``src/repro_torch/build/precision/``, one nvcc per copy,
  all started together;
- chip_smoke.py's two faulty scans around the shipped kernel.

For each it prints the loss and its difference from ``ssd_chunked``'s (the
faulty scans must lie more than 3e-4 from it), and the range over the
multi-chunk layers of chip_smoke.py's per-layer gate: each layer's call
against the plain version with split operands, in multiples of ``SPLIT_TOL``
(at most 1 passes).  For each kernel copy
it also prints the share of bf16 outputs that differ from ``ssd_scan_fwd``'s
on the first four layers' inputs, and its time at full width (CUDA events
around 20 back-to-back calls).  Prints one line per measurement and, last, a
JSON object of them all.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import SCORE_TOL, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, device_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sr  # noqa: E402
from repro_torch.kernels.ssd_scan.gate import SPLIT_TOL, LayerGate, faulty_scans  # noqa: E402

# name -> [(text of the source, its replacement)]
VARIANTS = {
    "as shipped (three bf16 terms)": [],
    "two bf16 terms (hi + lo)": [
        ("constexpr int TERMS = 3;", "constexpr int TERMS = 2;")],
    # each term's product is waited for and added, so these copies are slow
    # (every wgmma of the kernel serialised)
    "three terms, each wgmma of ssd_chunk_state from a zero accumulator, added in float32": [
        ("    hopper::wgmma_rs(d, a, db, 1);",
         "    float z[M];\n"
         "    for (int i = 0; i < M; ++i) z[i] = 0.f;\n"
         "    hopper::fence_regs(z);\n"
         "    hopper::wgmma_fence();\n"
         "    hopper::wgmma_rs(z, a, db, 0);\n"
         "    hopper::wgmma_commit();\n"
         "    hopper::wgmma_wait<0>();\n"
         "    hopper::fence_regs(z);\n"
         "    for (int i = 0; i < M; ++i) d[i] = __fadd_rn(d[i], z[i]);")],
    "three terms, each wgmma of ssd_chunk_scan from a zero accumulator, added in float32": [
        (f"    hopper::{call}(d, {ops}, 1);",
         "    float z[32];\n"
         "    for (int i = 0; i < 32; ++i) z[i] = 0.f;\n"
         "    hopper::fence_regs(z);\n"
         "    hopper::wgmma_fence();\n"
         f"    hopper::{call}(z, {ops}, 0);\n"
         "    hopper::wgmma_commit();\n"
         "    hopper::wgmma_wait<0>();\n"
         "    hopper::fence_regs(z);\n"
         "    for (int i = 0; i < 32; ++i) d[i] = __fadd_rn(d[i], z[i]);")
        for call, ops in (("wgmma_rs_m64n64k16", "a, db"), ("wgmma_ss_m64n64k16<1>", "da, db"))],
}
LAYERS_COMPARED = 4


def variant_library(index: int, name: str, edits) -> _build.CudaLibrary:
    """A copy of the K4 source with ``edits`` made, as a library."""
    src = sk.LIBRARY.source.read_text()
    header = sk.LIBRARY.source.parent / "../../csrc/hopper.cuh"
    edits = [('#include "../../csrc/hopper.cuh"', f'#include "{header.resolve()}"'), *edits]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds exactly one {old!r}")
        src = src.replace(old, new)
    path = _build.BUILD_DIR / "precision" / f"ssd_scan_precision{index}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return _build.CudaLibrary(f"ssd_scan_precision{index}", path, sk._bind,
                              error_fn="ssd_scan_error_string")


def fwd_on_float32(x, dt, A, B_, C_, D_, *, heads, chunk):
    """ssd_scan_fwd on float32 copies of bf16 x, B and C, cast back to x's dtype."""
    return sk.ssd_scan_call(x.float(), dt, A, B_.float(), C_.float(), D_, heads=heads,
                            chunk=chunk).to(x.dtype)


def plain(terms: int | None):
    """The plain version, its derived operands rounded to ``terms`` bf16 terms (None: float32)."""
    rounding = sr.split_bf16_round

    def scan(x, dt, A, B_, C_, D_, *, heads, chunk):
        if terms is None:
            return sr.ssd_scan_ref(x, dt, A, B_, C_, D_, heads=heads, chunk=chunk)
        with mock.patch.object(sr, "split_bf16_round", lambda v: rounding(v, terms)):
            return sr.ssd_scan_ref(x, dt, A, B_, C_, D_, heads=heads, chunk=chunk, split_bf16=True)
    return scan


def trained_params(seed: int, dev):
    """mamba2-370m after chip_smoke.py's training steps, without checkpoints."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb
    from repro_torch.core.daos import DaosEngine
    from repro_torch.training import Trainer

    cfg = dataclasses.replace(get_config("mamba2-370m"), attn_impl="naive", remat="full")
    hp = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                     checkpoint_every=TRAIN_STEPS + 1, async_checkpoint=False, seed=seed)
    fdb = make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=DaosEngine())
    trainer = Trainer(cfg, hp, fdb, run="precision", global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                      device=dev)
    trainer.train(TRAIN_STEPS, log_every=TRAIN_STEPS + 1)
    return cfg, trainer.params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_precision: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.data import SyntheticLM
    from repro_torch.models import train_loss

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi.splitlines()[0]}", flush=True)
    libraries = {name: variant_library(i, name, edits) for i, (name, edits) in enumerate(VARIANTS.items())}
    _build.build_all([sk.LIBRARY, *libraries.values()])
    for name, lib in libraries.items():
        if lib.build_log:
            print(f"[build] {name}: nvcc said\n{lib.build_log}", flush=True)

    cfg, params = trained_params(args.seed, dev)
    kernel_cfg = dataclasses.replace(cfg, attn_impl="pallas")
    held = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=args.seed + 1).batch_for_step(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in held.items()}
    result: dict[str, dict] = {}

    def score(name: str, **patches) -> float:
        """The loss through the scan that ``patches`` put in place, every layer's
        call held by chip_smoke.py's per-layer gate."""
        patched = mock.patch.multiple(sops, **patches) if patches else contextlib.nullcontext()
        with torch.no_grad(), patched:
            gate = LayerGate(sops.ssd_scan, {})
            with mock.patch.object(sops, "ssd_scan", gate):
                loss = float(train_loss(params, kernel_cfg, batch)[0])
        excess = [rec["scan"] for rec in gate.layers if rec["chunks"] > 1]
        result.setdefault(name, {}).update(loss=loss, gate_max=max(excess), gate_min=min(excess))
        return loss

    with torch.no_grad():
        chunked = float(train_loss(params, cfg, batch)[0])
    result["ssd_chunked"] = {"loss": chunked}
    inputs = []  # (args, ssd_scan_fwd's output) of the first layers

    def capture(*a, **kw):
        out = fwd_on_float32(*a, **kw)
        if len(inputs) < LAYERS_COMPARED:
            inputs.append((a, kw, out))
        return out
    score("ssd_scan_fwd on float32 copies", ssd_scan_call=capture)
    for name, terms in (("plain, float32", None), ("plain, two bf16 terms", 2),
                        ("plain, three bf16 terms", 3)):
        score(name, ssd_scan_call=plain(terms))
    for name, lib in libraries.items():
        with mock.patch.object(sk, "LIBRARY", lib):
            score(name)
            with torch.no_grad():
                differ = [float((sk.ssd_scan_call(*a, **kw) != want).float().mean())
                          for a, kw, want in inputs]
            a, kw, _ = inputs[0]
            ms = device_ms(lambda: sk.ssd_scan_call(*a, **kw))
        result[name].update({"outputs_differing_from_fwd": differ, "ms": ms})
    for name, scan in faulty_scans(sops.ssd_scan).items():
        score(f"faulty: {name}", ssd_scan=scan)

    for name, r in result.items():
        line = f"[precision] {name}: loss {r['loss']:.6f}, - ssd_chunked's {r['loss'] - chunked:+.3g}"
        if "gate_max" in r:
            line += (f"; per-layer gate: {r['gate_min']:.3g} to {r['gate_max']:.3g} of SPLIT_TOL "
                     f"({'passes' if r['gate_max'] <= 1 else 'fails'})")
        if "ms" in r:
            line += (f"; bf16 outputs differing from ssd_scan_fwd's at layers 0-{LAYERS_COMPARED - 1} "
                     + ", ".join(f"{v:.3g}" for v in r["outputs_differing_from_fwd"])
                     + f"; {r['ms']:.4f} ms at full width")
        print(line, flush=True)
    print(f"[precision] the faulty scans' losses must lie more than {SCORE_TOL} from ssd_chunked's; "
          f"the per-layer gate passes a scan within {SPLIT_TOL} of the plain version with split "
          "operands on every layer")
    print(json.dumps({"card": smi.splitlines()[0], "chunked": chunked, "results": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
