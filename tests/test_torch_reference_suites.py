"""The reference's own test suites, run against the port.

Each suite below is copied into a temporary directory with its absolute
``repro`` imports rebased to ``repro_torch`` and its imports of the
reference's hammer pointed at ``benchmarks/fdb_hammer_torch.py``, and all of
them run in one fresh pytest process, where ``jax`` and ``repro`` are
blocked in ``sys.modules`` and the port is asked to run on the CPU.  Cases
listed in ``DESELECT`` would drive packages the port does not have; every
other case must pass, and each suite counts as one test here."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from xml.etree import ElementTree

import pytest

pytest.importorskip("torch")

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
SRC = ROOT / "src"

SUITES = (
    "test_async_fdb.py",
    "test_batch_equivalence.py",
    "test_cache.py",
    "test_config.py",
    "test_contention.py",
    "test_core_fdb.py",
    "test_fields.py",
    "test_lifecycle.py",
    "test_metrics.py",
    "test_obs.py",
    "test_paper_claims.py",
    "test_remote.py",
    "test_request.py",
    "test_select.py",
    "test_stress_router.py",
    "test_workflow.py",
)

#: cases that need a package the port does not have (suite -> case ids)
DESELECT: dict[str, tuple[str, ...]] = {}

#: the reference's hammer, imported from benchmarks/ on the path or as a
#: module of the repository root, becomes its twin
_HAMMER = re.compile(r"^(\s*from (?:benchmarks\.)?fdb_hammer)(?= import)", re.M)

_CONFTEST = """\
import sys

sys.modules["jax"] = None
sys.modules["repro"] = None

from repro_torch.device import set_default_device  # noqa: E402

set_default_device("cpu")
"""

_REBASE = re.compile(r"^(\s*)(from|import) repro(?=[.\s])", re.M)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Run every suite in one pytest process; per suite, the outcomes."""
    root = tmp_path_factory.mktemp("reference_suites")
    shutil.copy(TESTS / "proptest.py", root / "proptest.py")
    (root / "conftest.py").write_text(_CONFTEST)
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "--junitxml", str(root / "report.xml")]
    for suite in SUITES:
        source = (TESTS / suite).read_text()
        assert re.search(r"^\s*(from|import) (jax|repro_torch)\b", source, re.M) is None, suite
        (root / suite).write_text(_HAMMER.sub(r"\1_torch", _REBASE.sub(r"\1\2 repro_torch", source)))
        cmd.append(suite)
        cmd += [arg for case in DESELECT.get(suite, ()) for arg in ("--deselect", f"{suite}::{case}")]
    # the hammer twin lives in benchmarks/, imported as fdb_hammer_torch or as
    # benchmarks.fdb_hammer_torch; the processes it spawns inherit this path
    path = os.pathsep.join(str(p) for p in (SRC, ROOT / "benchmarks", ROOT))
    env = dict(os.environ, PYTHONPATH=path, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=900)
    outcomes: dict[str, list[tuple[str, str]]] = {suite: [] for suite in SUITES}
    for case in ElementTree.parse(root / "report.xml").getroot().iter("testcase"):
        suite = case.get("classname", "").split(".")[0] + ".py"
        failed = [c.tag for c in case if c.tag in ("failure", "error", "skipped")]
        outcomes.setdefault(suite, []).append((case.get("name"), failed[0] if failed else "passed"))
    return out, outcomes


@pytest.mark.parametrize("suite", SUITES)
def test_reference_suite_passes_against_port(suite, results):
    out, outcomes = results
    cases = outcomes[suite]
    bad = [(name, kind) for name, kind in cases if kind != "passed"]
    assert cases and not bad, f"{suite}: {bad}\n{out.stdout[-3000:]}{out.stderr[-2000:]}"
