"""Where the time of the bf16 wgmma flash-attention kernel goes, by ablation.

    python3 tools/flash_attention_ablation.py [--reps 3] [--baseline OLD/flash_attention.cu]
        [--shape qwen2.5-3b] [--shape zamba2-7b]

Needs one CUDA card and nvcc.  Builds copies of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``, each with
one part of the wgmma instance taken out by a textual edit (the edits are
listed in ``ABLATIONS``; each must match the source exactly once), into
``src/repro_torch/build/ablation/``, one nvcc per copy, all started together.
Each ``--baseline`` source (another version of the kernel's file, with the
same C entry points) is built and timed beside them as it is.  At each
``--shape`` (``SHAPES``; qwen2.5-3b's full-width prefill, q 16 x 2048 x 128
over k/v 2 x 2048 x 128, unless another is named; zamba2-7b's longest served
prefill is q and k/v 32 x 1291 x 112), bf16 and causal, it times every copy,
the kernel as it ships bidirectional over half the keys (the same number of
attended pairs, with no diagonal block), and
``F.scaled_dot_product_attention`` on the same inputs, with CUDA events
around 20 back-to-back launches; the copies are timed in turn, ``--reps``
rounds, and the median of each is printed.  An ablated copy computes a wrong
answer on purpose: only its time is read.  The copies in ``EXACT`` change
how, not what, the kernel computes: each is held against the plain version
(2e-2) at every shape, and timed again at the shortest served prompt
(``SHORT`` tokens) with the shape's heads and head dim.

For every copy it prints what ``nvcc -Xptxas -v`` says of its kernel at each
shape's head dim: registers, spilled bytes, and performance warnings such as
C7511 (``wgmma`` serialised for lack of registers).  It also times, on the host,
one ``cuTensorMapEncodeTiled`` of a K map and one ``cudaFuncSetAttribute``
of the wgmma kernel (each launch encodes three maps; the attribute is set
once per device), and one wrapper call from an idle stream at the shortest
served prompt with the attribute set on every launch and once per device.

Prints one line per measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import BF16_PEAK, attention_bound, attention_pairs, call_ms, device_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

# name -> (KV heads, groups, tokens, head dim) of a causal bf16 prefill
SHAPES = {
    "qwen2.5-3b": (2, 8, 2048, 128),  # full width
    "zamba2-7b": (32, 1, 1291, 112),  # the longest of chip_smoke.py's served prompts at seed 0
}
SHORT = 123  # the shortest of chip_smoke.py's served prompt lengths at seed 0
HOST_D = 128  # head dim of the host probes

# name -> [(text of the source, its replacement)]
ABLATIONS = {
    "as shipped": [],
    "a runtime mask branch in every block's softmax": [
        ("if constexpr (decltype(mask)::value) {",
         "if (k0 + BKV > sk || (causal && k0 + BKV - 1 > q0 + 64 * c + q_offset)) {")],
    "no masks on the diagonal and tail blocks": [
        ("softmax(0, std::true_type{});", "softmax(0, std::false_type{});"),
        ("for (; kb < nk; ++kb) step(kb, std::true_type{});",
         "for (; kb < nk; ++kb) step(kb, std::false_type{});")],
    "half the exponentials (an odd column reuses its even neighbour's)": [
        ("exp2_approx(fmaf(acc_s[4 * j + e], scale_log2, (e & 2) ? -mn1 : -mn0));",
         "(e & 1) ? acc_s[4 * j + e - 1]"
         " : exp2_approx(fmaf(acc_s[4 * j + e], scale_log2, (e & 2) ? -mn1 : -mn0));")],
    "exp2 replaced by a multiply": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = x * 0.5f;")],
    "no softmax (P = raw scores, no rescaling)": [
        ("softmax(0, std::false_type{});", "alpha0 = alpha1 = 1.f;"),
        ("softmax(0, std::true_type{});", "alpha0 = alpha1 = 1.f;"),
        ("softmax(kb, mask);", "alpha0 = alpha1 = 1.f;")],
    "no turn-taking between the consumer warpgroups": [
        ("auto my_turn = [&]() { named_barrier(3 + c, 256); };", "auto my_turn = [&]() {};"),
        ("auto your_turn = [&]() { named_barrier_arrive(3 + (c ^ 1), 256); };",
         "auto your_turn = [&]() {};")],
    "two K/V stages in place of three": [
        ("static constexpr int STAGES = D <= 128 ? 3 : 2;", "static constexpr int STAGES = 2;")],
    "shared-memory attribute set on every launch": [
        ("cudaError_t cerr = allow_smem(kernel, smem, smem_devices);",
         "cudaError_t cerr =\n"
         "        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);")],
    "P.V at D = 112 on m64n128k16, over V's 16 zero columns too": [
        ("static constexpr int PV_N = D == 112 || D == 224 ? D : DP;",
         "static constexpr int PV_N = D == 224 ? D : DP;")],
}
# the copies that compute what the kernel as shipped computes
EXACT = ("as shipped", "two K/V stages in place of three",
         "shared-memory attribute set on every launch",
         "P.V at D = 112 on m64n128k16, over V's 16 zero columns too")

HOST_PROBE = """
#include <chrono>

// host time of one call, in microseconds, averaged over `reps`: what 0 is a
// tensor-map encode of a (heads, rows, D) bf16 tensor, 1 the wgmma kernel's
// shared-memory attribute
extern "C" double flash_attention_probe_host_us(int what, const void* base, int rows, int heads,
                                                int reps) {
    CUtensorMap map;
    int err = 0;
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < reps; ++i) {
        if (what == 0) {
            err |= hopper::encode_bf16_3d(&map, base, %(D)d, rows, heads, wg::BKV);
        } else {
            err |= (int)cudaFuncSetAttribute(wg::flash_attention_wgmma<%(D)d>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)wg::smem_bytes<%(D)d>());
        }
    }
    const double us =
        std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count();
    return err != 0 ? -1.0 : us / reps;
}
""" % {"D": HOST_D}


def ablated_library(index: int, name: str, edits, source: Path = fk.LIBRARY.source
                    ) -> _build.CudaLibrary:
    """A copy of ``source`` (the kernel's, by default) with ``edits`` made, as a library."""
    src = source.read_text()
    header = fk.LIBRARY.source.parent / "../../csrc/hopper.cuh"
    edits = [('#include "../../csrc/hopper.cuh"', f'#include "{header.resolve()}"'), *edits]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds exactly one {old!r}")
        src = src.replace(old, new)
    path = _build.BUILD_DIR / "ablation" / f"flash_attention_ablation{index}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src + HOST_PROBE)

    def bind(lib):
        fk._bind(lib)
        lib.flash_attention_probe_host_us.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.flash_attention_probe_host_us.restype = ctypes.c_double

    return _build.CudaLibrary(f"flash_attention_ablation{index}", path, bind,
                              error_fn="flash_attention_error_string")


def ptxas_report(libraries: dict[str, _build.CudaLibrary], dims) -> dict[str, dict]:
    """For each copy and each head dim in ``dims``, what ptxas says of its
    wgmma kernel: registers, spilled bytes, and its performance warnings
    (C7511: wgmma serialised).  One nvcc per copy with ``-Xptxas -v``, all
    started together."""
    procs = {}
    for name, lib in libraries.items():
        out = lib.source.with_suffix(".ptxas.so")
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(lib.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report = {}
    for name, proc in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc -Xptxas -v failed:\n" + "\n".join(lines))
        for d in dims:
            kernel = f"flash_attention_wgmmaILi{d}E"
            start = next(i for i, line in enumerate(lines)
                         if "Compiling entry function" in line and kernel in line)
            props = " ".join(lines[start + 1:start + 4])
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
            report[f"{name}, D = {d}"] = {
                "registers": int(re.search(r"Used (\d+) registers", props).group(1)),
                "spill_bytes": int(spills.group(1)) + int(spills.group(2)),
                "warnings": sorted({m.group(0) for line in lines if kernel in line
                                    for m in [re.search(r"\(C\d+\)", line)] if m}),
            }
    return report


def launcher(library: _build.CudaLibrary, q, k, v, *, causal: bool):
    """A call of ``library``'s wgmma instance on (q, k, v), as the wrapper makes it."""
    lib, (bh, sq, d), sk = library.load(), q.shape, k.shape[1]
    groups = bh // k.shape[0]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        out = torch.empty_like(q)
        err = lib.flash_attention_wgmma_launch(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk, groups,
            int(causal), 0, 1.0 / math.sqrt(d), stream)
        library.check(err, "flash_attention")
        return out

    return call


def time_shape(label: str, libraries, shape, reps: int, gen) -> dict:
    """Every copy, the shipped one bidirectional over half the keys, and SDPA
    at one causal prefill ``shape``; then the exact copies and SDPA at SHORT
    tokens.  Returns the medians and rounds."""
    kv_heads, groups, seq, d = shape

    def make(sq, sk):
        return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                for s in ((kv_heads * groups, sq, d), (kv_heads, sk, d), (kv_heads, sk, d))]

    def sdpa(q, k, v, causal=True):
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[None], k[None], v[None], is_causal=causal, enable_gqa=True)

    def check(calls, q, k, v):
        ref = flash_attention_ref(q, k, v, groups=groups, causal=True).float()
        errs = {}
        for name in EXACT:
            errs[name] = float((calls[name]().float() - ref).abs().max())
            assert errs[name] < 2e-2, f"{name} disagrees with plain at {label} by {errs[name]}"
        errs["scaled_dot_product_attention"] = float(
            (calls["scaled_dot_product_attention"]()[0].float() - ref).abs().max())
        return errs

    def rounds(calls):
        times: dict[str, list[float]] = {name: [] for name in calls}
        for _ in range(reps):
            for name, call in calls.items():
                times[name].append(device_ms(call))
        return times

    q, k, v = make(seq, seq)
    _, kh, vh = make(seq, seq // 2)
    calls = {name: launcher(lib, q, k, v, causal=True) for name, lib in libraries.items()}
    calls["as shipped, bidirectional over half the keys"] = launcher(
        libraries["as shipped"], q, kh, vh, causal=False)
    calls["scaled_dot_product_attention"] = sdpa(q, k, v)
    calls["scaled_dot_product_attention, bidirectional over half the keys"] = sdpa(q, kh, vh, False)
    errs = check(calls, q, k, v)
    times = rounds(calls)
    ms = {name: statistics.median(t) for name, t in times.items()}
    bound, by = attention_bound(kv_heads * groups, kv_heads, seq, seq, d, 2, True)
    flops = 4 * d * attention_pairs(seq, seq, True, 0) * kv_heads * groups
    shipped = ms["as shipped"]
    for name, t in ms.items():
        print(f"[{label}] {name}: {t:.4f} ms ({t - shipped:+.4f} ms against the kernel as "
              f"shipped; {flops / t / 1e9:.1f} TFLOP/s at the causal shape's "
              f"{flops / 1e9:.2f} GFLOP; rounds {', '.join(f'{x:.4f}' for x in times[name])})",
              flush=True)
    print(f"[{label}] q ({kv_heads * groups}, {seq}, {d}): bound {bound:.5f} ms by {by} "
          f"({flops / 1e9:.2f} GFLOP at {BF16_PEAK / 1e12:.0f} TFLOP/s bf16); max |copy - plain| "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()), flush=True)

    qs, ks, vs = make(SHORT, SHORT)
    short_calls = {name: launcher(libraries[name], qs, ks, vs, causal=True) for name in EXACT}
    short_calls["scaled_dot_product_attention"] = sdpa(qs, ks, vs)
    short_errs = check(short_calls, qs, ks, vs)
    short_times = rounds(short_calls)
    short_ms = {name: statistics.median(t) for name, t in short_times.items()}
    short_bound, short_by = attention_bound(kv_heads * groups, kv_heads, SHORT, SHORT, d, 2, True)
    for name, t in short_ms.items():
        print(f"[{label}, {SHORT} tokens] {name}: {t:.4f} ms (rounds "
              f"{', '.join(f'{x:.4f}' for x in short_times[name])})", flush=True)
    print(f"[{label}, {SHORT} tokens] bound {short_bound:.5f} ms by {short_by}; max |copy - plain| "
          + ", ".join(f"{n} {e:.3g}" for n, e in short_errs.items()), flush=True)
    return {"ms": ms, "rounds": times, "bound_ms": bound, "bound_by": by, "max_abs_err": errs,
            "short": {"tokens": SHORT, "ms": short_ms, "rounds": short_times,
                      "bound_ms": short_bound, "bound_by": short_by, "max_abs_err": short_errs}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another flash_attention.cu (an earlier commit's, say) whose wgmma "
                         "instance is timed beside the shipped one; may be repeated")
    ap.add_argument("--shape", choices=SHAPES, action="append", default=[],
                    help="a prefill shape to time at (default qwen2.5-3b); may be repeated")
    args = ap.parse_args()
    shapes = args.shape or ["qwen2.5-3b"]
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    libraries = {name: ablated_library(i, name, edits) for i, (name, edits) in enumerate(ABLATIONS.items())}
    for path in args.baseline:
        libraries[f"baseline {path}"] = ablated_library(len(libraries), str(path), [], path.resolve())
    t0 = time.perf_counter()
    _build.build_all(list(libraries.values()))
    print(f"[build] {len(libraries)} copies in {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = ptxas_report(libraries, sorted({SHAPES[s][3] for s in shapes}))
    for name, r in ptxas.items():
        print(f"[ptxas] {name}: {r['registers']} registers, {r['spill_bytes']} bytes spilled, "
              f"warnings {', '.join(r['warnings']) or 'none'}", flush=True)

    gen = torch.Generator("cuda").manual_seed(args.seed)
    timed = {s: time_shape(s, libraries, SHAPES[s], args.reps, gen) for s in shapes}

    kv_heads = SHAPES["qwen2.5-3b"][0]
    k = torch.randn((kv_heads, 2048, HOST_D), generator=gen, device="cuda").to(torch.bfloat16)
    lib = libraries["as shipped"].load()
    host = {"encode_us": lib.flash_attention_probe_host_us(0, k.data_ptr(), 2048, kv_heads, 10000),
            "set_attribute_us": lib.flash_attention_probe_host_us(1, k.data_ptr(), 2048, kv_heads,
                                                                  10000)}
    assert min(host.values()) > 0, f"a host probe failed: {host}"
    qs, ks, vs = (torch.randn((kv_heads * g, SHORT, HOST_D), generator=gen, device="cuda")
                  .to(torch.bfloat16) for g in (SHAPES["qwen2.5-3b"][1], 1, 1))
    for name in ("as shipped", "shared-memory attribute set on every launch"):
        call = launcher(libraries[name], qs, ks, vs, causal=True)
        call()
        host[f"call_ms, {name}"] = call_ms(call, reps=200)
    for key, val in host.items():
        print(f"[host] {key}: {val:.4f}", flush=True)
    print(json.dumps({"card": smi, "shapes": timed, "host": host, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
