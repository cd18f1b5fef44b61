"""Benchmark harness entry point — one benchmark per paper table/figure.

Prints ``name,us_per_call,derived`` CSV lines (stdout) and writes the full
per-figure CSVs under artifacts/bench_torch/.  Roofline terms come from
the port's dry-run records if present (artifacts/dryrun_torch).

    PYTHONPATH=src python benchmarks/run_torch.py [--device cuda|cpu]

``--device`` (default ``cuda``) is where the port runs.  bench_kernels times
the plain PyTorch versions at the reference's shapes under its line names;
on the card each is followed by a line for the hand-written kernel at the
same shape, naming the instance that ran and its launch count.
"""

from __future__ import annotations

import time


def _line(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.2f},{derived}")


def bench_paper_figures() -> None:
    from . import figures_torch as figures

    t0 = time.perf_counter()
    rows3 = figures.fig3_parameter_optimisation()
    best = max(rows3, key=lambda r: r["GiBps"])
    _line("fig3_parameter_optimisation(sim)", 1e6 * (time.perf_counter() - t0),
          f"best={best['backend']}/{best['mode']}/ratio{best['ratio']}/ppn{best['ppn']}:{best['GiBps']:.1f}GiBps")

    t0 = time.perf_counter()
    rows4 = figures.fig4_short_scaling()
    d = {(r["backend"], r["mode"], r["contention"], r["n"]): r["GiBps"] for r in rows4}
    _line("fig4_short_scaling(sim)", 1e6 * (time.perf_counter() - t0),
          f"16srv w+r-contention write: daos={d[('daos','write',True,16)]:.1f} lustre={d[('lustre','write',True,16)]:.1f} GiBps")

    t0 = time.perf_counter()
    prof = figures.fig5_profiling()
    top_w = next(iter(prof["writer"]))
    top_r = next(iter(prof["reader"]))
    _line("fig5_profiling(real-daos)", 1e6 * (time.perf_counter() - t0),
          f"writer-top={top_w}:{prof['writer'][top_w]:.0f}% reader-top={top_r}:{prof['reader'][top_r]:.0f}%")

    t0 = time.perf_counter()
    rows6 = figures.fig6_long_scaling()
    d6 = {(r["backend"], r["mode"], r["contention"], r["n"]): r["GiBps"] for r in rows6}
    daos_c = d6[("daos", "write", True, 16)]
    lus_c = d6[("lustre", "write", True, 16)]
    _line("fig6_long_scaling(sim)", 1e6 * (time.perf_counter() - t0),
          f"16srv contention: daos={daos_c:.1f} lustre={lus_c:.1f} GiBps (daos/lustre={daos_c/lus_c:.2f}x)")

    t0 = time.perf_counter()
    lst = figures.listing_comparison()
    _line("listing_comparison(real)", 1e6 * lst["posix"]["list_s"],
          f"posix_faster_by={lst['posix_speedup']:.2f}x entries={lst['posix']['entries']}")

    t0 = time.perf_counter()
    hb = figures.hammer_bandwidths()
    parts = [f"{r['backend']}/{r['mode']}={r['bandwidth_GiBps']:.2f}GiBps" for r in hb]
    _line("fdb_hammer(real-backends)", 1e6 * (time.perf_counter() - t0), " ".join(parts))

    t0 = time.perf_counter()
    ch = figures.churn_interference()
    worst = max(ch, key=lambda r: r["interference_ratio"])
    bad = sum(r["failed_reads"] + r["duplicate_reads"] for r in ch)
    _line("churn_interference(real-backends)", 1e6 * (time.perf_counter() - t0),
          f"worst={worst['backend']}/n{worst['n_procs']}:"
          f"{worst['interference_ratio']:.2f}x migrated={worst['fields_migrated']} "
          f"audit_failures={bad}")


def bench_kernels(device: str = "cuda") -> None:
    import torch

    from repro_torch.kernels import launches
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.grib_pack import ops as gops
    from repro_torch.kernels.grib_pack.ref import field_stats, pack_ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def timed(fn, reps: int) -> float:
        """Seconds per call of ``fn`` after one warm-up call, on the host's
        clock with the card drained (``block_until_ready`` in the reference)."""
        fn()
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if on_card:
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps

    def kernel(name: str, fn, plain_out, tol: dict, reps: int, key: str, derived) -> None:
        """The hand-written kernel's line at the plain line's shape: its
        instance and launch count from the kernels' launch counter, and its
        largest difference from its plain version's output ``plain_out``,
        which it must be within ``tol`` of."""
        launches.reset()
        dt = timed(fn, reps)
        n = launches.snapshot()[key]
        ran = "+".join(launches.by(key, "instance")) or key
        out = fn()
        torch.testing.assert_close(out.float(), plain_out.float(), **tol)
        err = float((out.float() - plain_out.float()).abs().max())
        _line(name, 1e6 * dt, f"{derived(dt)} instance={ran} launches={n} max_abs_err={err:.3g}")

    f32_tol = dict(atol=2e-4, rtol=2e-4)  # tests/test_kernels.py, float32

    # flash attention: the plain version (what the kernel computes) and the kernel
    q = randn(1, 1024, 4, 2, 64)
    k = randn(1, 1024, 4, 64)
    v = randn(1, 1024, 4, 64)
    qf = q.permute(0, 2, 3, 1, 4).reshape(8, 1024, 64)
    kf, vf = (t.permute(0, 2, 1, 3).reshape(4, 1024, 64) for t in (k, v))
    plain = lambda: flash_attention_ref(qf, kf, vf, groups=2, causal=True)  # noqa: E731
    dt = timed(plain, 5)
    flops = 4 * 1024 * 1024 * 8 * 64 * 2
    _line("attention_ref_1k", 1e6 * dt, f"{flops/dt/1e9:.1f}GFLOPs_{dev.type}")
    if on_card:
        out = plain().reshape(1, 4, 2, 1024, 64).permute(0, 3, 1, 2, 4)
        kernel("flash_attention_1k", lambda: fops.flash_attention(q, k, v, causal=True), out, f32_tol, 5,
               "flash_attention", lambda t: f"{flops/t/1e9:.1f}GFLOPs_{dev.type}")

    x = randn(2, 512, 8, 32)
    dtv = torch.nn.functional.softplus(randn(2, 512, 8))
    A = -torch.exp(randn(8))
    B_ = randn(2, 512, 16)
    C_ = randn(2, 512, 16)
    D_ = torch.ones(8, device=dev)
    plain = lambda: ssd_chunked(x, dtv, A, B_, C_, D_, chunk=128)  # noqa: E731
    _line("ssd_chunked_512", 1e6 * timed(plain, 5), f"oracle_{dev.type}")
    if on_card:  # held against the kernel's plain version, not ssd_chunked
        xf, dtf, af, df = sops.flatten(x, dtv, A, D_)
        out = ssd_scan_ref(xf, dtf, af, B_, C_, df, heads=8, chunk=128)
        out = out.reshape(2, 8, 512, 32).permute(0, 2, 1, 3)
        kernel("ssd_scan_512", lambda: sops.ssd_scan(x, dtv, A, B_, C_, D_, chunk=128), out,
               f32_tol, 5, "ssd_scan", lambda t: f"kernel_{dev.type}")

    f = randn(8, 256, 512) * 30 + 250
    plain = lambda: pack_ref(f, *field_stats(f)[::2])  # noqa: E731
    dt = timed(plain, 10)
    _line("grib_pack_8x256x512", 1e6 * dt, f"{f.numel()*4/dt/2**30:.2f}GiBps_{dev.type}")
    if on_card:
        kernel("grib_pack_kernel_8x256x512", lambda: gops.grib_pack(f, nbits=16)[0], plain(),
               dict(atol=0, rtol=0), 10, "grib_pack", lambda t: f"{f.numel()*4/t/2**30:.2f}GiBps_{dev.type}")


def bench_ckpt_overlap() -> None:
    from .ckpt_overlap_torch import run_overlap_benchmark

    t0 = time.perf_counter()
    r = run_overlap_benchmark()
    _line("ckpt_async_overlap(real)", 1e6 * (time.perf_counter() - t0),
          f"blocking={r['blocking_s']:.2f}s async={r['async_s']:.2f}s "
          f"io_hidden={100*r['io_hidden_frac']:.0f}%")


def bench_roofline() -> None:
    import os

    from .roofline_table_torch import ART, load_records

    if not os.path.isdir(ART):
        _line("roofline_table", 0.0, "no-dryrun-artifacts")
        return
    recs = [r for r in load_records() if r.get("status") == "ok"]
    for mesh in ("pod16x16", "pod2x16x16"):
        sub = [r for r in recs if r.get("mesh") == mesh]
        if not sub:
            continue
        bound = {}
        for r in sub:
            bound[r["roofline"]["bottleneck"]] = bound.get(r["roofline"]["bottleneck"], 0) + 1
        _line(f"roofline_{mesh}", 0.0, f"cells={len(sub)} bottlenecks={bound}")


def main(argv: list[str] | None = None) -> None:
    import argparse

    from repro_torch.device import set_default_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="where the port runs (default: cuda)")
    args = ap.parse_args(argv)
    set_default_device(args.device)
    print("name,us_per_call,derived")
    bench_paper_figures()
    bench_kernels(args.device)
    bench_ckpt_overlap()
    bench_roofline()


if __name__ == "__main__":
    if not __package__:  # run as a file: import the twins as the package benchmarks
        import sys
        from pathlib import Path

        _root = Path(__file__).resolve().parents[1]
        sys.path[:0] = [str(_root), str(_root / "src")]
        __package__ = "benchmarks"
    main()
