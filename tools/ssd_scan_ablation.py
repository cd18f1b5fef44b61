"""Where the time of the SSD scan's chunk-output launch (``ssd_chunk_scan``) goes, by ablation.

    python3 tools/ssd_scan_ablation.py [--reps 2] [--baseline OLD/ssd_scan.cu]

Needs one CUDA card and nvcc.  Builds copies of
``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``, each changed by the
textual edits of ``ABLATIONS`` (each must match the source exactly once),
into ``src/repro_torch/build/ablation/``, one nvcc per copy, all started
together.  Each ``--baseline`` source (another version of the file with the
same C entry points, such as an older commit's: ``git show
<rev>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu > .archive/old.cu``)
is built and timed beside them as it is.

At the full-width scoring shape (``chip_smoke.SSD_FULL``: x 256 x 2048 x 64,
B and C 8 x 2048 x 128, bf16, chunk 256) it times ``ssd_chunk_scan`` of every
copy on the same inputs and the same float32 scratch, with CUDA events around
20 back-to-back launches; the copies are timed in turn, ``--reps`` rounds,
and the median of each is printed.  The copies in ``EXACT`` change how, not
what, the launch computes: each is held against
``ssd_chunk_scan_ref(split_bf16=True)`` at ``SPLIT_TOL`` at the full-width
shape, at a chunk of 20 rows (ragged tiles) and at a chunk of 512 rows (two
windows of G tiles).  The others compute a wrong answer on purpose: only
their time is read.  For every copy it prints what ``ptxas -v`` says of
``ssd_chunk_scan<128>``: registers, spilled bytes, and performance notes
such as C7513 and C7520 (every wgmma of the kernel serialised).

Prints one line per measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import SSD_FULL, device_ms, ptxas_lines, ssd_flat, ssd_inputs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sr  # noqa: E402
from repro_torch.kernels.ssd_scan.gate import SPLIT_TOL, excess  # noqa: E402

# name -> [(text of the source, its replacement)]
ABLATIONS = {
    "as shipped": [],
    "expf for the decay": [("exp_f32(d)", "expf(d)")],
    "the warpgroup index without the shuffle": [
        ("const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);",
         "const int wgi = threadIdx.x / 128;")],
    # a branch between a wgmma fence and its products, true on every full
    # tile: ptxas then serialises every wgmma of the kernel
    "a branch around each product of scores . x": [
        ("term_rs(acc, cur[kk][tm], db);", "if (jrows > 16 * kk) term_rs(acc, cur[kk][tm], db);")],
    "no exponential (the exponent in its place)": [("exp_f32(d)", "(d)")],
    "no C_i . h^T": [("            if (c > 0) {\n#pragma unroll 1", "            if (c < 0) {\n#pragma unroll 1")],
    "scores . x on term 0 alone": [
        ("term_rs(acc, cur[kk][tm], db);", "if (tm == 0) term_rs(acc, cur[kk][tm], db);")],
}
EXACT = ("as shipped", "expf for the decay", "the warpgroup index without the shuffle",
         "a branch around each product of scores . x")
# (batch, seq, heads, head dim, state, chunk) of the exact copies' checks
CHECKS = (SSD_FULL, (2, 100, 3, 64, 64, 20), (1, 1024, 3, 64, 128, 512))


def _bind(lib: ctypes.CDLL) -> None:
    """The three launches of the split instance, which every version of the
    source exports alike."""
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_state_launch.argtypes = [c_int, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int, c_int,
                                           c_int, ptr]
    lib.ssd_state_pass_launch.argtypes = [c_int, ptr, ptr, ptr, c_int, c_int, c_int, ptr]
    lib.ssd_chunk_scan_launch.argtypes = [c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int,
                                          c_int, c_int, ptr]
    for fn in (lib.ssd_chunk_state_launch, lib.ssd_state_pass_launch, lib.ssd_chunk_scan_launch):
        fn.restype = c_int


def ablated_library(index: int, name: str, edits, source: Path = sk.LIBRARY.source) -> _build.CudaLibrary:
    """A copy of ``source`` with ``edits`` made, as a library built with ptxas -v."""
    src = source.read_text()
    header = (sk.LIBRARY.source.parent / "../../csrc/hopper.cuh").resolve()
    for old, new in [('#include "../../csrc/hopper.cuh"', f'#include "{header}"'), *edits]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds exactly one {old!r}")
        src = src.replace(old, new)
    path = _build.BUILD_DIR / "ablation" / f"ssd_scan_ablation{index}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return _build.CudaLibrary(f"ssd_scan_ablation{index}", path, _bind, error_fn="ssd_scan_error_string",
                              extra_flags=("-Xptxas", "-v"))


def ptxas_report(lib: _build.CudaLibrary) -> dict:
    """ptxas -v of ssd_chunk_scan<128>, and its C75xx notes."""
    said = [v for k, v in ptxas_lines(lib.build_log, "ssd_chunk_scan").items() if "ILi128E" in k]
    notes = sorted({line.split(")")[0].split("(")[-1] for line in lib.build_log.splitlines()
                    if "(C75" in line and "ssd_chunk_scan" in line})
    return {"ptxas": said[0] if said else "", "notes": notes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_scan_ablation: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi.splitlines()[0]}", flush=True)
    libraries = {name: ablated_library(i, name, edits) for i, (name, edits) in enumerate(ABLATIONS.items())}
    for j, path in enumerate(args.baseline):
        libraries[f"baseline {path}"] = ablated_library(len(ABLATIONS) + j, str(path), [], path.resolve())
    _build.build_all(list(libraries.values()))
    result = {name: ptxas_report(lib) for name, lib in libraries.items()}

    gen = torch.Generator(dev).manual_seed(0)
    inputs = {case: ssd_flat(*ssd_inputs(gen, *case[:5], torch.bfloat16, dev)) for case in CHECKS}
    times: dict[str, list[float]] = {name: [] for name in libraries}
    for rep in range(args.reps):
        for name in (libraries if rep % 2 == 0 else reversed(list(libraries))):
            with mock.patch.object(sk, "LIBRARY", libraries[name]):
                for case, flat in inputs.items():
                    if case != SSD_FULL and name not in EXACT:
                        continue
                    scan = sk.SplitScan(*flat, heads=case[2], chunk=case[5])
                    scan.run()
                    if rep == 0 and (name in EXACT or name.startswith("baseline")):
                        x, dt, _, bb, cc, d = flat
                        want = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=case[2],
                                                     chunk=case[5], split_bf16=True)
                        result[name].setdefault("excess", {})[str(case)] = excess(scan.out, want)
                    if case == SSD_FULL:
                        times[name].append(device_ms(scan.chunk_scan))
    for name, r in result.items():
        r["ms"] = statistics.median(times[name])
        line = f"[ablation] {name}: ssd_chunk_scan {r['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in times[name])})"
        if "excess" in r:
            line += "; against the plain function, of SPLIT_TOL: " + ", ".join(
                f"{case} {v:.3g}" for case, v in r["excess"].items())
        line += f"; ptxas: {r['ptxas']}" + (f"; notes {', '.join(r['notes'])}" if r["notes"] else "")
        print(line, flush=True)
    bad = {name: r["excess"] for name, r in result.items() if name in EXACT and max(r["excess"].values()) > 1}
    print(json.dumps({"card": smi.splitlines()[0], "shape": SSD_FULL, "split_tol": SPLIT_TOL,
                      "results": result}))
    if bad:
        print(f"ssd_scan_ablation: copies that must keep the answer do not: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
