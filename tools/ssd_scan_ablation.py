"""Where the time of the split SSD-scan instance's two launches goes, by ablation.

    python3 tools/ssd_scan_ablation.py [--reps 2] [--baseline OLD/ssd_scan.cu] [--bitwise]
        [--only NAME ...] [--source OTHER/ssd_scan.cu]

Needs one CUDA card and nvcc.  Builds copies of
``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu``, each changed by the
textual edits of ``ABLATIONS`` (each must match the source exactly once),
into ``src/repro_torch/build/ablation/``, one nvcc per copy, all started
together.  Each ``--baseline`` source (another version of the file with the
same C entry points, such as a later commit's: ``git show
<rev>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu > .archive/old.cu``)
is built and timed beside them as it is.

At the full-width scoring shape (``chip_smoke.SSD_FULL``: x 256 x 2048 x 64,
B and C 8 x 2048 x 128, bf16, chunk 256) it times both launches of every
copy, ``ssd_chunk_state`` (the chunk states and the chained state pass) and
``ssd_chunk_scan`` (the chunk outputs), on the same inputs, with CUDA events
around 20 back-to-back launches of each; the copies are timed in turn,
``--reps`` rounds, and the median of each is printed.  The copies in
``EXACT`` change how, not what, the launches compute: each is held at the
full-width shape, at a chunk of 20 rows (ragged tiles) and at a chunk of 512
rows (a turning B ring in the first launch, two windows of G tiles in the
second) against the plain functions, in multiples of their tolerances (at
most 1 passes): ``ssd_chunk_state``'s cumsum and chunk states (through its
check output) against ``ssd_chunk_state_ref(split_bf16=True)`` and its
states entering each chunk against ``ssd_state_pass_ref`` of its own chunk
states, at chip_smoke's ``SCRATCH_TOL``, and ``ssd_chunk_scan``'s output
against ``ssd_chunk_scan_ref(split_bf16=True)`` at ``SPLIT_TOL``.  The others
compute a wrong answer on purpose: only their time is read.  For every copy
it prints what ``ptxas -v`` says of ``ssd_chunk_state<128>`` and
``ssd_chunk_scan<128>``: registers, spilled bytes, and performance notes
such as C7513 and C7520 (every wgmma of the kernel serialised).

With ``--bitwise``, each baseline's ``ssd_chunk_scan`` is also held bit for
bit against the source as shipped at every ``CHECKS`` shape, both on the
same inputs and the same cum and h (the shipped first launch's): a redesign
that keeps every sum's order must give the same bits.  ``--only`` builds
and times the named copies alone, beside the source as shipped; ``--source``
makes the copies from another version of the file (its edits must match it).

Prints one line per measurement and, last, a JSON object of them all; exits
1 if a copy in ``EXACT`` leaves its tolerance or a ``--bitwise`` check finds
a bit that differs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import SCRATCH_TOL, SSD_FULL, device_ms, ptxas_lines, ssd_flat, ssd_inputs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sr  # noqa: E402
from repro_torch.kernels.ssd_scan.gate import SPLIT_TOL, excess  # noqa: E402

# edits of ssd_chunk_state that more than one copy makes
_NO_CHAIN = ("const bool chained = c > 0;", "const bool chained = false;")
_NO_H_STORE = ("for (int e = 0; e < N / 2; ++e) hn[at_np(e)] =",
               "for (int e = 0; e < N / 2; ++e) if (et < 0.f) hn[at_np(e)] =")
_NO_FLAG = ("if (t == 0) flag_release(flags + (size_t)bh * nc + c + 1);",
            "if (et < 0.f) flag_release(flags + (size_t)bh * nc + c + 1);")
_NO_PRODUCTS = ("    hopper::wgmma_rs(d, a, db, 1);\n", "")
# edits of ssd_chunk_scan that more than one copy makes
_NO_INTER = ("            if (c > 0) {\n#pragma unroll 1", "            if (c < 0) {\n#pragma unroll 1")
_NO_G_PRODUCTS = ("for (int kk = 0; kk < N / 16; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")
_NO_G_STORE = ("                gt[jj * 128 + t] =", "                if (nb < 0) gt[jj * 128 + t] =")
_NO_X_READ = ("const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at_row + p);",
              "const __nv_bfloat162 xv = __floats2bfloat162_rn(dv, ec);")
_NO_Y_STORE = ("*reinterpret_cast<__nv_bfloat162*>(y + at_row + p) = __floats2bfloat162_rn(y0, y1);",
               "if (y0 == 1234.5f && y1 == -1234.5f) *reinterpret_cast<__nv_bfloat162*>(y + at_row + p) = "
               "__floats2bfloat162_rn(y0, y1);")

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
    "no C_i . h^T": [_NO_INTER],
    "scores . x on term 0 alone": [
        ("term_rs(acc, cur[kk][tm], db);", "if (tm == 0) term_rs(acc, cur[kk][tm], db);")],
    # ssd_chunk_scan's fixed costs: the block's prologue and G phase (the B
    # tiles still loaded, the G products and stores skipped: the scores read
    # stale shared memory), the epilogue's x read and y store (each output
    # computed, stored only where it equals a value it never takes), scores .
    # x alone, and every block cut to one j tile (the cost of a block with
    # one tile's steps per head)
    "no G tiles made (stale shared memory read in their place)": [_NO_G_PRODUCTS, _NO_G_STORE],
    "no x read or y store in the epilogue": [_NO_X_READ, _NO_Y_STORE],
    "scores . x alone (no C_i . h^T, no x read or y store)": [_NO_INTER, _NO_X_READ, _NO_Y_STORE],
    "ssd_chunk_scan with one j tile a block": [("const int nj = ib + 1;", "const int nj = 1;")],
    # every block loads C_i and makes its G tiles, then has no head to scan:
    # the launch's blocks, their prologues and G phases alone
    "ssd_chunk_scan's blocks with no heads (prologue and G phase alone)": [
        ("const int c = rest % nc, bg = rest / nc;\n    const int h0 = g * group, nh = min(group, heads - h0);",
         "const int c = rest % nc, bg = rest / nc;\n    const int h0 = g * group, nh = 0 * min(group, heads - h0);")],
    "ssd_chunk_scan with two x stages": [("constexpr int XS = 3;", "constexpr int XS = 2;")],
    # ssd_chunk_state: h_{c+1} = S_c, no block waiting for its predecessor
    "ssd_chunk_state without the chained wait (the recurrence skipped)": [_NO_CHAIN],
    "ssd_chunk_state's products on term 0 alone": [
        ("state_term(acc, cur[ks][tm], db);", "if (tm == 0) state_term(acc, cur[ks][tm], db);")],
    "ssd_chunk_state with one head a block": [
        ("constexpr int STATE_GROUP = 2;", "constexpr int STATE_GROUP = 1;")],
    "ssd_chunk_state with four heads a block": [
        ("constexpr int STATE_GROUP = 2;", "constexpr int STATE_GROUP = 4;")],
    "ssd_chunk_state with eight heads a block": [
        ("constexpr int STATE_GROUP = 2;", "constexpr int STATE_GROUP = 8;")],
    "ssd_chunk_state with two x stages": [
        ("constexpr int STATE_XS = 3;", "constexpr int STATE_XS = 2;")],
    # h_{c+1} computed but not stored (et > 0): the bytes of the state pass's writes
    "ssd_chunk_state without the store of h": [_NO_H_STORE],
    # the three parts of its time: the products alone (no recurrence, no store
    # of h, no flags), then without the products too (the A words, the x loads
    # and the cumsum)
    "ssd_chunk_state's products, no recurrence or store of h": [_NO_CHAIN, _NO_H_STORE, _NO_FLAG],
    "ssd_chunk_state's A words, x loads and cumsum alone": [_NO_CHAIN, _NO_H_STORE, _NO_FLAG, _NO_PRODUCTS],
}
EXACT = ("as shipped", "expf for the decay", "the warpgroup index without the shuffle",
         "a branch around each product of scores . x", "ssd_chunk_state with one head a block",
         "ssd_chunk_state with four heads a block", "ssd_chunk_state with eight heads a block",
         "ssd_chunk_state with two x stages", "ssd_chunk_scan with two x stages")
LAUNCHES = ("ssd_chunk_state", "ssd_chunk_scan")
# (batch, seq, heads, head dim, state, chunk) of the exact copies' checks
CHECKS = (SSD_FULL, (2, 100, 3, 64, 64, 20), (1, 1024, 3, 64, 128, 512))


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
    return _build.CudaLibrary(f"ssd_scan_ablation{index}", path, sk._bind, error_fn="ssd_scan_error_string",
                              extra_flags=("-Xptxas", "-v"))


def ptxas_report(lib: _build.CudaLibrary) -> dict:
    """ptxas -v of each launch's kernel at N 128, and its C75xx notes."""
    out = {}
    for launch in LAUNCHES:
        said = [v for k, v in ptxas_lines(lib.build_log, launch).items() if "ILi128E" in k]
        notes = sorted({line.split(")")[0].split("(")[-1] for line in lib.build_log.splitlines()
                        if "(C75" in line and launch in line})
        out[launch] = {"ptxas": said[0] if said else "", "notes": notes}
    return out


def launch_excess(scan, flat, heads: int, chunk: int) -> dict:
    """Each launch of ``scan`` (a SplitScan that has run) against its plain
    functions, in multiples of the tolerance: the first launch again with its
    check output."""
    x, dt, A, bb, cc, d = flat
    states = torch.empty((scan.bh, scan.s // scan.q - 1, scan.n, x.shape[-1]), dtype=torch.float32,
                         device=x.device)
    scan.chunk_state(states)
    cum, want_states = sr.ssd_chunk_state_ref(x, dt, A, bb, heads=heads, chunk=chunk, split_bf16=True)
    out = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=heads, chunk=chunk,
                                split_bf16=True)
    return {"ssd_chunk_state": max(excess(scan.cum, cum, SCRATCH_TOL),
                                   excess(states, want_states, SCRATCH_TOL),
                                   excess(scan.h, sr.ssd_state_pass_ref(states, scan.cum, chunk=chunk),
                                          SCRATCH_TOL)),
            "ssd_chunk_scan": excess(scan.out, out)}


def same_bits(lib: _build.CudaLibrary, baseline: _build.CudaLibrary, inputs: dict) -> dict[str, int]:
    """ssd_chunk_scan of ``lib`` and of ``baseline`` on the same inputs and
    the same cum and h (``lib``'s first launch): at each case, how many
    outputs differ in any bit."""
    out = {}
    for case, flat in inputs.items():
        with mock.patch.object(sk, "LIBRARY", lib):
            first = sk.SplitScan(*flat, heads=case[2], chunk=case[5])
            first.run()
        with mock.patch.object(sk, "LIBRARY", baseline):
            second = sk.SplitScan(*flat, heads=case[2], chunk=case[5])
            second.cum.copy_(first.cum)
            second.h.copy_(first.h)
            second.chunk_scan()
        torch.cuda.synchronize()
        a, b = first.out.view(torch.int16), second.out.view(torch.int16)
        out[str(case)] = int((a != b).sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--baseline", type=Path, action="append", default=[])
    ap.add_argument("--only", action="append", default=[], metavar="NAME",
                    help="build and time only these copies (and the source as shipped)")
    ap.add_argument("--source", type=Path, default=sk.LIBRARY.source,
                    help="the version of ssd_scan.cu the copies are made from (default: the repo's)")
    ap.add_argument("--bitwise", action="store_true",
                    help="hold ssd_chunk_scan's output bit for bit against each --baseline's")
    args = ap.parse_args()
    unknown = set(args.only) - set(ABLATIONS)
    if unknown:
        ap.error(f"no such copies: {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("ssd_scan_ablation: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi.splitlines()[0]}", flush=True)
    libraries = {name: ablated_library(i, name, edits, args.source.resolve())
                 for i, (name, edits) in enumerate(ABLATIONS.items())
                 if not args.only or name in args.only or not edits}
    for j, path in enumerate(args.baseline):
        libraries[f"baseline {path}"] = ablated_library(len(ABLATIONS) + j, str(path), [], path.resolve())
    _build.build_all(list(libraries.values()))
    result = {name: ptxas_report(lib) for name, lib in libraries.items()}

    gen = torch.Generator(dev).manual_seed(0)
    inputs = {case: ssd_flat(*ssd_inputs(gen, *case[:5], torch.bfloat16, dev)) for case in CHECKS}
    times = {name: {launch: [] for launch in LAUNCHES} for name in libraries}
    for rep in range(args.reps):
        for name in (libraries if rep % 2 == 0 else reversed(list(libraries))):
            with mock.patch.object(sk, "LIBRARY", libraries[name]):
                for case, flat in inputs.items():
                    if case != SSD_FULL and name not in EXACT:
                        continue
                    scan = sk.SplitScan(*flat, heads=case[2], chunk=case[5])
                    scan.run()
                    if rep == 0 and (name in EXACT or name.startswith("baseline")):
                        result[name].setdefault("excess", {})[str(case)] = launch_excess(
                            scan, flat, case[2], case[5])
                    if case == SSD_FULL:
                        times[name]["ssd_chunk_state"].append(device_ms(scan.chunk_state))
                        times[name]["ssd_chunk_scan"].append(device_ms(scan.chunk_scan))
    for name, r in result.items():
        r["ms"] = {launch: statistics.median(t) for launch, t in times[name].items()}
        line = f"[ablation] {name}: " + ", ".join(
            f"{launch} {r['ms'][launch]:.4f} ms ({', '.join(f'{t:.4f}' for t in times[name][launch])})"
            for launch in LAUNCHES)
        if "excess" in r:
            line += "; against the plain functions, of the tolerance: " + ", ".join(
                f"{case} {launch} {v:.3g}" for case, e in r["excess"].items() for launch, v in e.items())
        for launch in LAUNCHES:
            rp = r[launch]
            line += f"; {launch} ptxas: {rp['ptxas']}" + (f", notes {', '.join(rp['notes'])}" if rp["notes"] else "")
        print(line, flush=True)
    bad = {name: r["excess"] for name, r in result.items()
           if name in EXACT and max(v for e in r["excess"].values() for v in e.values()) > 1}
    differ = {}
    if args.bitwise:
        for name in libraries:
            if name.startswith("baseline"):
                result[name]["bitwise"] = same_bits(libraries["as shipped"], libraries[name], inputs)
                print(f"[bitwise] ssd_chunk_scan of the source as shipped against {name}, on the same "
                      "cum and h: " + ", ".join(f"{case} {'equal' if n == 0 else f'{n} outputs differ'}"
                                                for case, n in result[name]["bitwise"].items()), flush=True)
                if any(result[name]["bitwise"].values()):
                    differ[name] = result[name]["bitwise"]
    print(json.dumps({"card": smi.splitlines()[0], "shape": SSD_FULL, "split_tol": SPLIT_TOL,
                      "scratch_tol": SCRATCH_TOL, "results": result}))
    if bad:
        print(f"ssd_scan_ablation: copies that must keep the answer do not: {bad}", file=sys.stderr)
    if differ:
        print(f"ssd_scan_ablation: ssd_chunk_scan's bits differ from a baseline's: {differ}", file=sys.stderr)
    return 1 if bad or differ else 0


if __name__ == "__main__":
    sys.exit(main())
