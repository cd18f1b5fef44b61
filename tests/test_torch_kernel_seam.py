"""The seam between the models and the hand-written kernels.

Every kernel package owns its plain version (``ref.py``) beside its kernel
and its wrapper, and no module under ``src/repro_torch/kernels/`` imports
``repro_torch.models``: the models import the plain versions and the
wrappers from there, never the other way round.  The files are parsed with
``ast``, not imported.  The wrappers' one launch counter loses no count
when threads (the codec's writers) count at once.
"""

import ast
import sys
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import launches  # noqa: E402

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


def _imports_models(path: Path) -> list[str]:
    """The import statements of ``path`` that name ``repro_torch.models``,
    absolutely or relatively, at any depth of the file."""
    package = path.relative_to(KERNELS.parents[1]).parent.parts  # ("repro_torch", "kernels", ...)
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = list(package[:len(package) - node.level + 1]) if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            names = [module] + [f"{module}.{alias.name}" for alias in node.names]
        else:
            continue
        if any(n == "repro_torch.models" or n.startswith("repro_torch.models.") for n in names):
            found.append(f"{path.relative_to(KERNELS)}:{node.lineno}")
    return found


def test_kernel_packages_own_their_plain_versions_and_never_import_models():
    packages = sorted(p.parent.name for p in KERNELS.glob("*/kernel.py"))
    assert packages == ["causal_conv", "flash_attention", "grib_pack", "rms_norm", "ssd_scan"]
    for name in packages:
        assert {"kernel.py", "ops.py", "ref.py"} <= {p.name for p in (KERNELS / name).glob("*.py")}, name
    found = [hit for path in sorted(KERNELS.rglob("*.py")) for hit in _imports_models(path)]
    assert found == [], f"kernel modules import repro_torch.models: {found}"


def test_the_launch_counter_loses_no_count_across_threads():
    threads, each = 16, 2000
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        launches.reset()
        workers = [threading.Thread(target=lambda i=i: [launches.count("k", instance=i % 2, head_dim=64)
                                                        for _ in range(each)]) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(before)
    assert launches.snapshot()["k"] == threads * each
    assert launches.by("k", "instance") == {0: threads * each // 2, 1: threads * each // 2}
    assert launches.by("k", "head_dim") == {64: threads * each}
    launches.reset()
    assert launches.snapshot() == {} and launches.snapshot()["k"] == 0
