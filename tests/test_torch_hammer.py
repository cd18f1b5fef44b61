"""The fdb-hammer twin (benchmarks/fdb_hammer_torch.py), the paper-figure and
checkpoint-overlap twins, and the port's cluster simulator, against the
reference: the virtual-clock client-scaling sweep gives the same cells in
both packages, raw and through the codec; the tiered codec deployment runs
through every io mode on the CPU; the reference's hammer-codec cases hold
for the twin; the simulated figures agree; and the twins, with the clients
the remote sweep spawns, run without JAX or ``repro``.  The port runs on the
CPU, the reference's codec in interpret mode."""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
sys.path.append(str(ROOT))  # benchmarks.figures(_torch) import the hammers relatively

import fdb_hammer as jh  # noqa: E402
import fdb_hammer_torch as th  # noqa: E402
from repro_torch.core.codec import kernel_launches, reset_kernel_launches, wire_size  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402

#: the only sweep values read off the wall clock: the codec's pack/unpack
#: latencies, which the codec times itself (every other latency and every
#: bandwidth runs on the contention model's virtual clock)
WALL_CLOCK = re.compile(r"\.latency\.codec_(pack|unpack)\.p(50|95|99)_s$")


@pytest.fixture(autouse=True)
def on_cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def flat(tree, path=""):
    """(dotted path, leaf) pairs of a JSON-like tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("codec_nbits", (None, 16), ids=("raw", "codec16"))
def test_virtual_clock_scaling_sweep_gives_the_same_cells(codec_nbits):
    kw = dict(backends=("posix", "daos"), procs_list=(1, 2), out=None, codec_nbits=codec_nbits)
    ref = jh.scaling_sweep(jh.HammerSpec(n_steps=2, n_params=2, n_levels=2, field_size=1 << 13), **kw)
    port = th.scaling_sweep(th.HammerSpec(n_steps=2, n_params=2, n_levels=2, field_size=1 << 13), **kw)
    a, b = dict(flat(ref)), dict(flat(port))
    assert a.keys() == b.keys()
    wall = {k for k in a if WALL_CLOCK.search(k)}
    assert bool(wall) == (codec_nbits is not None)
    assert {k: a[k] for k in a if k not in wall} == {k: b[k] for k in b if k not in wall}
    for k in wall:
        assert b[k] > 0.0


def test_tiered_codec_config_runs_every_io_mode():
    spec = th.HammerSpec(n_procs=3, n_steps=2, n_params=2, n_levels=3, field_size=1 << 13,
                         codec_nbits=16)
    rows = th.run_config(th.load_config("tiered-codec"), spec)
    ref = jh.run_config(jh.load_config("tiered-codec"), jh.HammerSpec(**dataclasses.asdict(spec)),
                        io_modes=("batched",))[0]
    per_tier = spec.n_steps * spec.n_params * spec.n_levels  # fields of one member
    hot = per_tier * wire_size(spec.field_shape, 16)  # member 0: 16-bit DAOS tier
    cold = 2 * per_tier * wire_size(spec.field_shape, 24)  # members 1-2: 24-bit POSIX tier
    assert [r["io"] for r in rows] == list(th.IO_MODES)
    for row in rows:
        assert row["effective_bytes_written"] == spec.total_bytes
        assert row["effective_bytes_read"] == spec.total_bytes
        assert row["n_parts"] == 2 and row["listed_step0"] == 3 * spec.n_params * spec.n_levels
        # tier bytes carry catalogue writes beside the payloads; how many
        # the POSIX tier makes depends on how the threads interleave, so
        # the tier and wire byte counts are not compared across runs
        assert row["part_bytes_written"][0] >= hot and row["part_bytes_written"][1] >= cold
        assert row["wire_bytes_written"] == sum(row["part_bytes_written"])
        for key in ("listed_step0", "n_parts", "effective_bytes_written", "effective_bytes_read"):
            assert row[key] == ref[key], key


# the cases of tests/test_codec.py::TestHammerCodec, against the twin

def test_scaling_sweep_reports_codec_cells(tmp_path):
    spec = th.HammerSpec(n_steps=2, n_params=2, n_levels=2, field_size=1 << 13)
    out = str(tmp_path / "BENCH_contention_torch.json")
    res = th.scaling_sweep(spec, backends=("posix",), procs_list=(1, 2), out=out, codec_nbits=16)
    assert set(res["backends"]) == {"posix", "posix+codec16"}
    with open(out) as f:
        bench = json.load(f)
    for row in bench["backends"]["posix+codec16"]["sweep"]:
        for phase in ("write", "read"):
            r = row[phase]
            assert r["effective_GiBps"] >= 1.5 * r["wire_GiBps"]
            assert r["codec_ratio"] >= 1.5
    assert "codec_ratio" not in bench["backends"]["posix"]["sweep"][0]["write"]


def test_archive_packs_one_launch_per_step_batch(tmp_path):
    spec = th.HammerSpec(n_procs=2, n_steps=3, n_params=2, n_levels=2, field_size=1 << 13,
                         codec_nbits=16)
    fdb = th.make_backend("posix", root=str(tmp_path), codec_nbits=16)
    try:
        reset_kernel_launches()
        th.run_hammer(fdb, spec, "archive")
        assert kernel_launches()["pack"] == spec.n_procs * spec.n_steps
        w = th.run_hammer(fdb, spec, "archive")
    finally:
        fdb.close()
    assert w["codec_ratio"] >= 1.5
    assert w["effective_GiBps"] >= 1.5 * w["wire_GiBps"]


def test_tiered_codec_config_round_trips():
    spec = th.HammerSpec(n_procs=2, n_steps=2, n_params=2, n_levels=2, field_size=1 << 13,
                         codec_nbits=16)
    row = th.run_config(th.load_config("tiered-codec"), spec, io_modes=("batched",))[0]
    assert row["effective_bytes_written"] == spec.total_bytes
    assert row["wire_bytes_written"] > 0
    assert row["codec_ratio_w"] > 1.0


def test_simulated_figures_agree(monkeypatch, tmp_path):
    from benchmarks import figures as jf
    from benchmarks import figures_torch as tf

    monkeypatch.setattr(jf, "ART", str(tmp_path / "ref"))
    monkeypatch.setattr(tf, "ART", str(tmp_path / "port"))
    assert tf.fig3_parameter_optimisation() == jf.fig3_parameter_optimisation()
    assert tf.fig4_short_scaling() == jf.fig4_short_scaling()
    assert tf.fig6_long_scaling() == jf.fig6_long_scaling()
    assert tf.fig5_profiling() == jf.fig5_profiling()  # op counts of the real DAOS engine
    assert (tmp_path / "port" / "fig3_parameter_optimisation.csv").read_text() == \
        (tmp_path / "ref" / "fig3_parameter_optimisation.csv").read_text()


_BLOCKED = """\
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.device import set_default_device
set_default_device("cpu")
"""


def run_blocked(code: str, tmp_path: Path, *, with_reference_on_path: bool = True) -> str:
    """Run ``code`` in a fresh interpreter where importing jax or repro
    fails.  Without the reference on the path, only ``repro_torch`` (linked
    into a directory of its own) and benchmarks/ are importable, so the
    processes it spawns cannot import ``repro`` either."""
    if with_reference_on_path:
        path = [ROOT / "src", ROOT / "benchmarks", ROOT]
    else:
        pkgs = tmp_path / "pkgs"
        pkgs.mkdir()
        (pkgs / "repro_torch").symlink_to(ROOT / "src" / "repro_torch")
        path = [pkgs, ROOT / "benchmarks"]
    code += ("\nbad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
             "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
             "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(map(str, path)))
    out = subprocess.run([sys.executable, "-c", _BLOCKED + code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_twins_run_without_jax_or_repro(tmp_path):
    out = run_blocked(f"""
import repro_torch.core.remote, repro_torch.roofline, repro_torch.simulation
from benchmarks import ckpt_overlap_torch, figures_torch
figures_torch.ART = {str(tmp_path / "art")!r}
rows = figures_torch.fig3_parameter_optimisation()
lst = figures_torch.listing_comparison()
ov = ckpt_overlap_torch.run_overlap_benchmark(n_steps=6, ckpt_every=3, step_s=0.005)
sim = repro_torch.simulation.simulate("daos", repro_torch.simulation.Workload(1, 1, 4, 100))
roof = repro_torch.roofline.codec_roofline("pack", (2, 16, 128))
print(len(rows), lst["posix"]["entries"], ov["blocking_s"] > 0, sim.bandwidth_GiBps > 0, roof.bound)
""", tmp_path)
    assert out.split()[-5:] == ["48", "120", "True", "True", "memory"]


def test_harness_twin_prints_the_reference_lines_on_the_cpu(tmp_path):
    """``benchmarks/run_torch.py --device cpu`` run as a file: every line name
    of ``benchmarks/run.py`` in its order, no kernel line (the caller asked
    for the CPU), and with no dry-run records the reference's last line."""
    out = run_blocked(f"""
import runpy
import benchmarks.figures_torch
import benchmarks.roofline_table_torch
benchmarks.figures_torch.ART = {str(tmp_path / "art")!r}
benchmarks.roofline_table_torch.ART = {str(tmp_path / "no_dryrun")!r}
sys.argv = ["run_torch.py", "--device", "cpu"]
runpy.run_path({str(ROOT / "benchmarks" / "run_torch.py")!r}, run_name="__main__")
""", tmp_path)
    lines = out.splitlines()
    names = re.findall(r'^\s*_line\("([^"]+)"', (ROOT / "benchmarks" / "run.py").read_text(), re.M)
    assert lines[0] == "name,us_per_call,derived"
    assert [line.split(",", 1)[0] for line in lines[1:]] == names
    assert lines[-1] == "roofline_table,0.00,no-dryrun-artifacts"
    kernels = {line.split(",")[0]: line.split(",")[2] for line in lines[1:]}
    assert kernels["attention_ref_1k"].endswith("GFLOPs_cpu")
    assert kernels["ssd_chunked_512"] == "oracle_cpu"
    assert kernels["grib_pack_8x256x512"].endswith("GiBps_cpu")
    assert sorted(p.name for p in (tmp_path / "art").iterdir())[:2] == [
        "churn_interference.csv", "fig3_parameter_optimisation.csv"]


def test_remote_sweep_spawns_clients_that_import_only_the_port(tmp_path):
    out = run_blocked("""
import json
import fdb_hammer_torch as h
spec = h.HammerSpec(n_steps=1, n_params=2, n_levels=2, field_size=1 << 12)
res = h.remote_sweep(spec, backends=("daos",), procs_list=(1, 2), out=None)
print(json.dumps(res["backends"]["daos+remote"]))
""", tmp_path, with_reference_on_path=False)
    cell = json.loads(out.splitlines()[-1])
    assert [row["n_procs"] for row in cell["sweep"]] == [1, 2]
    for row in cell["sweep"]:
        n = row["n_procs"]
        assert row["measured"] and row["wire"]["connections"] >= n
        assert row["wire"]["bytes_read"] >= n * 4 * (1 << 12)  # archived payloads in
        assert row["wire"]["bytes_written"] >= n * 4 * (1 << 12)  # retrieved payloads out
        assert row["write"]["agg_GiBps"] > 0 and row["read"]["agg_GiBps"] > 0
