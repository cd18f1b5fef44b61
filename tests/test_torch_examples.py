"""The workflow examples' torch twins (examples/quickstart_torch.py and
examples/nwp_workflow_torch.py), and the serving example for the ssm,
hybrid, moe and vlm families (examples/serve_decode_torch.py --arch), run to
the end with ``--device cpu``, in an interpreter where importing jax or
repro fails; the workflow twins refuse to run on a card that is not there
when no device is asked for."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_RUN = """\
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


def run_example(name: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _RUN, str(ROOT / "examples" / name), *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_quickstart_runs_on_the_cpu():
    out = run_example("quickstart_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "16-bit GRIB simple packing on cpu" in out.stdout
    assert "daos: visible before flush? -> True" in out.stdout
    assert "posix: visible before flush? -> False" in out.stdout
    assert "tiered select: 2 fields across 2 tiers" in out.stdout
    assert "x2.00 bandwidth win" in out.stdout


def test_nwp_workflow_runs_on_the_cpu():
    out = run_example("nwp_workflow_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "GRIB-packed on cpu" in out.stdout
    for line in ("DAOS  (sync ):", "POSIX (sync ):", "DAOS  (async):", "POSIX (async):"):
        assert line in out.stdout
    assert "merged list(param=2t) sees 25 fields across both tiers" in out.stdout
    assert "GiB/s write under contention" in out.stdout


@pytest.mark.parametrize("arch,family", [("mamba2-370m", "ssm"), ("zamba2-7b", "hybrid"),
                                         ("granite-moe-3b-a800m", "moe"), ("internvl2-76b", "vlm")])
def test_serve_decode_runs_every_family_on_the_cpu(arch, family):
    out = run_example("serve_decode_torch.py", "--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "9", "--tokens", "4", "--consumers", "2")
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"arch={arch} family={family}" in out.stdout
    assert "disseminate: 2 consumers x 8 fields" in out.stdout


@pytest.mark.parametrize("name", ("quickstart_torch.py", "nwp_workflow_torch.py"))
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    out = run_example(name)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
