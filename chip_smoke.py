"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. card: the card's name and power limit, the torch and CUDA versions, and
   the nvcc build of every kernel of the path (from the sources in this
   checkout);
2. kernels: 32 float32 fields on the 1801x3600 0.1-degree lat-lon grid,
   made on the card from a numpy seed; for nbits 8, 16 and 24 the CUDA
   pack/unpack kernels must equal their plain PyTorch versions bit for bit,
   ref/scale on the card must equal the CPU's, and the round trip must stay
   within quantum*1.01 + 2 ulp; kernel, plain and library times come from
   CUDA events around runs of back-to-back launches, beside the bound set
   by the card's memory rate;
3. path: the tiered codec deployment (number=0 to a 16-bit DAOS tier, the
   rest to a 24-bit POSIX tier) archives one output step of 2 members x 16
   fields with archive_fields, flushes, and reads it back with
   retrieve_fields("step=0").arrays(); every field must be within its
   tier's quantum, every payload header well formed, and the CUDA kernels
   must have been launched exactly as often as the codec says.  The step
   runs twice: untraced for the numbers, then traced for the span
   breakdown, which splits each codec launch into its host and card steps.

The line before the last is one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the rest of this repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

F, H, W = 32, 1801, 3600  # one step of the 0.1-degree HRES grid
MEMBERS, PER_MEMBER = 2, 16
NBITS = (8, 16, 24)
TIER_NBITS = {"0": 16, "1": 24}  # number=0 -> hot DAOS tier, else cold POSIX
# peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
HBM_RATE = 3.35e12  # bytes/s
F32_PEAK = 67e12  # float32 operations/s outside the tensor cores

TIERED_CODEC_CONFIG = {
    "type": "select",
    "rules": [
        {
            "match": "number=0",
            "fdb": {"type": "codec", "nbits": 16,
                    "inner": {"backend": "daos", "schema": "nwp-daos"}},
        },
    ],
    "default": {"type": "codec", "nbits": 24,
                "inner": {"backend": "posix", "schema": "nwp-posix"}},
}


def say(msg: str) -> None:
    print(msg, flush=True)


def make_fields(f: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """Smooth harmonics around a base temperature plus noise, on the card;
    every coefficient and the noise come from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    lat = torch.linspace(-math.pi / 2, math.pi / 2, h, device=device)[:, None]
    lon = torch.linspace(0, 2 * math.pi, w + 1, device=device)[:-1][None, :]
    noise = torch.from_numpy(rng.standard_normal(h * w, dtype=np.float32)).to(device)
    base = rng.uniform(220.0, 300.0, f)
    amp = rng.uniform(2.0, 30.0, (f, 4))
    kx, ky = rng.integers(1, 12, (f, 4)), rng.integers(1, 8, (f, 4))
    phase = rng.uniform(0, 2 * math.pi, (f, 4))
    shift = rng.integers(0, h * w, f)
    out = torch.empty((f, h, w), dtype=torch.float32, device=device)
    for i in range(f):
        field = torch.full((h, w), float(base[i]), device=device)
        for j in range(4):
            field += float(amp[i, j]) * torch.sin(int(kx[i, j]) * lon + float(phase[i, j])) \
                * torch.cos(int(ky[i, j]) * lat)
        out[i] = field + 0.5 * noise.roll(int(shift[i])).view(h, w)
    return out


def device_ms(fn, launches: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: one CUDA-event pair around
    ``launches`` back-to-back calls, divided by their count, so the host's
    launch cost hides behind the queued work; the median over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def call_ms(fn, reps: int = 20) -> float:
    """Time of one call of ``fn`` from an idle stream, its host-side checks,
    allocation and launch included: a CUDA-event pair around a single call,
    median over ``reps``.  Beside :func:`device_ms` it shows the wrapper's cost."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def library_unpack(codes: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes codes*scale + ref per field (int32
    codes promote to float32); timed as the library yardstick, used nowhere
    in the port."""
    return torch.addcmul(ref[:, None, None], codes, scale[:, None, None])


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def within_quantum(x: torch.Tensor, y: torch.Tensor, nbits: int) -> tuple[bool, float]:
    """Per field: max|y - x| <= quantum*1.01 + 2 ulp of max|x|; returns the
    verdict and the largest error as a fraction of its bound."""
    lo = x.amin(dim=(1, 2)).double()
    hi = x.amax(dim=(1, 2)).double()
    quantum = torch.clamp(hi - lo, min=1e-30) / ((1 << nbits) - 1)
    top = x.abs().amax(dim=(1, 2)).cpu().numpy()
    ulp = torch.from_numpy(np.spacing(top).astype(np.float64)).to(x.device)
    bound = quantum * 1.01 + 2 * ulp
    err = (y - x).abs().amax(dim=(1, 2)).double()
    return bool((err <= bound).all()), float((err / bound).max())


def drive_path(x: torch.Tensor, keys: list, *, trace: bool) -> dict:
    """One output step through the tiered codec deployment: archive_fields,
    flush, retrieve_fields("step=0").arrays(), with every check of the
    phase.  The kernel counts are set to 0 just before and read just after."""
    from repro_torch.core import build_fdb
    from repro_torch.core.codec import (
        CODEC_HEADER_SIZE, kernel_launches, parse_header, reset_kernel_launches,
    )
    from repro_torch.kernels.grib_pack import ops as gops

    cfg = json.loads(json.dumps(TIERED_CODEC_CONFIG))
    cfg["trace"] = trace
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fdb_") as root:
        cfg["default"]["inner"]["root"] = root
        with build_fdb(cfg) as fdb:
            torch.cuda.synchronize()
            reset_kernel_launches()
            gops.reset_kernel_launches()
            t0 = time.perf_counter()
            fdb.archive_fields(keys, x)
            fdb.flush()
            t_archive = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = fdb.retrieve_fields("step=0")
            arrays = got.arrays()
            t_retrieve = time.perf_counter() - t0
            launches = dict(gops.KERNEL_LAUNCHES)
            codec_counts = kernel_launches()

            assert codec_counts == {"pack": 2, "unpack": 2}, codec_counts  # one pack per tier
            assert launches == {"grib_pack": codec_counts["pack"],
                                "grib_unpack": codec_counts["unpack"]}, launches
            assert arrays.shape == x.shape and arrays.dtype == np.float32
            assert np.isfinite(arrays).all()
            index = {k: i for i, k in enumerate(keys)}
            order = [index[k] for k in got.keys]
            assert sorted(order) == list(range(len(keys))), "retrieve did not return every field"
            back = torch.from_numpy(arrays).to(x.device)
            for number, nbits in TIER_NBITS.items():
                sel = [j for j, k in enumerate(got.keys) if k["number"] == number]
                ok, frac = within_quantum(x[[order[j] for j in sel]], back[sel], nbits)
                assert ok, f"tier number={number} outside its {nbits}-bit quantum ({frac:.3f})"
                if not trace:
                    say(f"[path] tier number={number}: {len(sel)} fields, {nbits}-bit, "
                        f"worst error {frac:.3f} of quantum*1.01 + 2 ulp")
            wire = 0
            for k in keys:
                payload = fdb.read(k)
                hdr = parse_header(payload, context=str(k))
                assert (hdr.nbits, hdr.height, hdr.width) == (TIER_NBITS[k["number"]], H, W), hdr
                assert len(payload) == CODEC_HEADER_SIZE + hdr.body_size
                wire += len(payload)
            eff = fdb.stats_snapshot()["effective_bytes_written"]
            assert eff == x.numel() * 4, eff
            spans: dict[str, list] = {}
            for sp in fdb._trace.spans():
                tot = spans.setdefault(sp.name, [0.0, 0])
                tot[0] += sp.duration_s
                tot[1] += 1
    return {"archive_s": t_archive, "retrieve_s": t_retrieve, "launches": launches,
            "codec_counts": codec_counts, "wire": wire, "spans": spans}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import Key
    from repro_torch.kernels.grib_pack import kernel as gk
    from repro_torch.kernels.grib_pack import ops as gops
    from repro_torch.kernels.grib_pack.ref import field_stats, pack_ref, unpack_ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)

    # ---------------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"[card] {smi}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" devices {torch.cuda.device_count()} memory rate used for bounds {HBM_RATE / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    lib = gk.build()  # one source, one nvcc
    say(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------------------- 2. kernels
    t0 = time.perf_counter()
    x = make_fields(F, H, W, args.seed, dev)
    torch.cuda.synchronize()
    n = x.numel()
    say(f"[kernels] inputs {tuple(x.shape)} float32 made on the card in {time.perf_counter() - t0:.2f} s")
    x_cpu = x.cpu()
    max_err = {"grib_pack": 0.0, "grib_unpack": 0.0}
    for nbits in NBITS:
        codes, ref, scale = gops.grib_pack(x, nbits=nbits)
        lo, sc, inv = field_stats(x, nbits)
        plain_codes = pack_ref(x, lo, inv, nbits)
        out = gops.grib_unpack(codes, ref, scale)
        plain_out = unpack_ref(codes, ref, scale)
        torch.cuda.synchronize()
        c_lo, c_sc, c_inv = field_stats(x_cpu, nbits)
        assert torch.equal(bits(ref), bits(lo)) and torch.equal(bits(scale), bits(sc)), nbits
        assert torch.equal(bits(lo).cpu(), bits(c_lo)), f"ref on the card != CPU at nbits={nbits}"
        assert torch.equal(bits(sc).cpu(), bits(c_sc)), f"scale on the card != CPU at nbits={nbits}"
        assert torch.equal(bits(inv).cpu(), bits(c_inv)), f"inv_scale on the card != CPU at nbits={nbits}"
        pack_err = float((codes.long() - plain_codes.long()).abs().max())
        unpack_err = float((out - plain_out).abs().max())
        assert torch.equal(codes, plain_codes), f"pack kernel != plain at nbits={nbits} (max {pack_err})"
        assert torch.equal(bits(out), bits(plain_out)), f"unpack kernel != plain (max {unpack_err})"
        max_err["grib_pack"] = max(max_err["grib_pack"], pack_err)
        max_err["grib_unpack"] = max(max_err["grib_unpack"], unpack_err)
        ok, frac = within_quantum(x, out, nbits)
        assert ok, f"round trip outside quantum*1.01 + 2 ulp at nbits={nbits} ({frac:.3f} of bound)"
        pk = device_ms(lambda: gk.grib_pack_call(x, ref, inv, nbits=nbits))
        pp = device_ms(lambda: pack_ref(x, lo, inv, nbits))
        uk = device_ms(lambda: gk.grib_unpack_call(codes, ref, scale))
        up = device_ms(lambda: unpack_ref(codes, ref, scale))
        nbytes = 8 * n + 8 * F
        bound = nbytes / HBM_RATE * 1e3
        say(f"[kernels] nbits={nbits} exact vs plain, round trip {frac:.3f} of its bound; "
            f"pack {pk:.4f} ms ({nbytes / pk / 1e6:.0f} GB/s) plain {pp:.4f} ms; "
            f"unpack {uk:.4f} ms ({nbytes / uk / 1e6:.0f} GB/s) plain {up:.4f} ms; "
            f"{nbytes / 1e9:.3f} GB moved per pass, bound {bound:.4f} ms")
        del codes, ref, scale, lo, sc, inv, plain_codes, out, plain_out
    say("[kernels] library_ms of grib_pack: none, no single PyTorch call computes GRIB simple "
        "packing (min/max, scale, round half to even, clip, cast); grib_unpack's library call "
        "is torch.addcmul(ref, codes, scale)")

    # the main path packs and unpacks one tier's slice: (16, H, W) per launch
    xs = x[:PER_MEMBER]
    ns = xs.numel()
    timing = {}
    for nbits in sorted(set(TIER_NBITS.values())):
        codes, ref, scale = gops.grib_pack(xs, nbits=nbits)
        _, _, inv = field_stats(xs, nbits)
        assert torch.equal(codes, pack_ref(xs, ref, inv, nbits))
        out = gops.grib_unpack(codes, ref, scale)
        assert torch.equal(bits(out), bits(unpack_ref(codes, ref, scale)))
        lib_err = float((library_unpack(codes, ref, scale) - out).abs().max())
        pack_call = lambda: gk.grib_pack_call(xs, ref, inv, nbits=nbits)  # noqa: E731
        unpack_call = lambda: gk.grib_unpack_call(codes, ref, scale)  # noqa: E731
        timing[nbits] = {
            "grib_pack": {"ms": device_ms(pack_call), "call_ms": call_ms(pack_call),
                          "plain_ms": device_ms(lambda: pack_ref(xs, ref, inv, nbits)),
                          "library_ms": None},
            "grib_unpack": {"ms": device_ms(unpack_call), "call_ms": call_ms(unpack_call),
                            "plain_ms": device_ms(lambda: unpack_ref(codes, ref, scale)),
                            "library_ms": device_ms(lambda: library_unpack(codes, ref, scale))},
        }
        say(f"[kernels] main-path shape {tuple(xs.shape)} nbits={nbits}: "
            + "; ".join(f"{k} {v['ms']:.4f} ms (one call from idle {v['call_ms']:.4f} ms) "
                        f"plain {v['plain_ms']:.4f} ms" for k, v in timing[nbits].items())
            + f"; library addcmul {timing[nbits]['grib_unpack']['library_ms']:.4f} ms, "
            f"max |addcmul - kernel| {lib_err:.3g}")
    del codes, ref, scale, inv, out
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 3. path
    keys = [
        Key({"class": "od", "stream": "enfo", "expver": "0001", "date": "20240101",
             "time": "0000", "type": "pf", "levtype": "pl", "number": str(m),
             "levelist": lev, "step": "0", "param": p})
        for m in range(MEMBERS)
        for p in ("t", "u", "v", "q")
        for lev in ("1000", "850", "500", "250")
    ]
    assert len(keys) == F
    eff = x.numel() * 4
    run = drive_path(x, keys, trace=False)  # the measured run: no tracer
    launches = run["launches"]
    gib = 1024 ** 3
    say(f"[path] archive_fields+flush {run['archive_s']:.3f} s = {eff / gib / run['archive_s']:.3f} GiB/s "
        f"effective; retrieve_fields+arrays {run['retrieve_s']:.3f} s = "
        f"{eff / gib / run['retrieve_s']:.3f} GiB/s effective; "
        f"effective/wire {eff / run['wire']:.4f} ({eff} / {run['wire']} B)")
    say(f"[path] kernel launches {launches}, codec counts {run['codec_counts']}")
    traced = drive_path(x, keys, trace=True)  # the same run again, traced
    say(f"[path] traced run: archive {traced['archive_s']:.3f} s, retrieve {traced['retrieve_s']:.3f} s; "
        "span seconds over the step, with counts (nested spans overlap): "
        + ", ".join(f"{k} {v[0]:.4f} ({v[1]})"
                    for k, v in sorted(traced["spans"].items(), key=lambda kv: -kv[1][0])))
    for side in ("pack", "unpack"):
        steps = {k: v for k, v in traced["spans"].items() if k.startswith(f"codec.{side}.")}
        assert steps, f"the traced run recorded no codec.{side} step spans"
        say(f"[path] codec.{side} steps over both tiers (ms): "
            + ", ".join(f"{k.rsplit('.', 1)[1]} {v[0] * 1e3:.1f}" for k, v in steps.items()))

    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, f"the port loaded {loaded}"

    kernels = []
    for kname, line in (("grib_pack", 31), ("grib_unpack", 39)):
        t = timing[16][kname]
        nbytes = 8 * ns + 8 * PER_MEMBER
        ops = (5 if kname == "grib_pack" else 3) * ns
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/grib_pack/csrc/grib_pack.cu",
            "replaces": f"src/repro/kernels/grib_pack/kernel.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max_err[kname],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(nbytes / HBM_RATE, ops / F32_PEAK) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_RATE >= ops / F32_PEAK else "operations",
            "library_ms": t["library_ms"],
        })
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
