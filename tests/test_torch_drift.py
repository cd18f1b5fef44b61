"""Every module the port carries over from the reference unchanged must stay
equal to it as text, apart from absolute ``repro.`` imports rebased to
``repro_torch.``.  The benchmark twins under ``benchmarks/`` are held to
their references the same way, with a short named allow-list.  The
reference is read as text and never imported."""

import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

#: modules copied from repro and kept equal to it
CARRIED = (
    "cache/__init__.py",
    "cache/fdb.py",
    "cache/shard.py",
    "cache/singleflight.py",
    "checkpoint/__init__.py",
    "configs/__init__.py",
    "configs/base.py",
    "configs/granite_moe_3b_a800m.py",
    "configs/internlm2_20b.py",
    "configs/internvl2_76b.py",
    "configs/mamba2_370m.py",
    "configs/nwp_100m.py",
    "configs/phi35_moe_42b.py",
    "configs/phi3_mini_3_8b.py",
    "configs/qwen25_3b.py",
    "configs/whisper_tiny.py",
    "configs/yi_34b.py",
    "configs/zamba2_7b.py",
    "core/__init__.py",
    "core/async_fdb.py",
    "core/catalogue.py",
    "core/client.py",
    "core/config.py",
    "core/costmodel.py",
    "core/datahandle.py",
    "core/fdb.py",
    "core/fieldset.py",
    "core/keys.py",
    "core/request.py",
    "core/router.py",
    "core/schema.py",
    "core/select.py",
    "core/store.py",
    "core/remote/__init__.py",
    "core/remote/client.py",
    "core/remote/protocol.py",
    "core/remote/server.py",
    "core/daos/__init__.py",
    "core/daos/engine.py",
    "core/daos/objects.py",
    "core/daos/pool.py",
    "core/daos/server.py",
    "core/daos_backend/__init__.py",
    "core/daos_backend/catalogue.py",
    "core/daos_backend/store.py",
    "core/posix/__init__.py",
    "core/posix/catalogue.py",
    "core/posix/stats.py",
    "core/posix/store.py",
    "data/__init__.py",
    "data/pipeline.py",
    "fields/__init__.py",
    "fields/synthetic.py",
    "lifecycle/__init__.py",
    "lifecycle/engine.py",
    "lifecycle/policy.py",
    "metrics/__init__.py",
    "metrics/contention.py",
    "metrics/histogram.py",
    "metrics/iostats.py",
    "obs/__init__.py",
    "obs/export.py",
    "obs/tracer.py",
    "simulation/__init__.py",
    "simulation/cluster.py",
)

#: modules the port rewrote for torch (same path as a reference module)
PORTED = (
    "checkpoint/manager.py",
    "checkpoint/serialization.py",
    "core/codec.py",
    "distributed/__init__.py",
    "distributed/sharding.py",
    "distributed/zero.py",
    "kernels/__init__.py",
    "kernels/flash_attention/__init__.py",
    "kernels/flash_attention/kernel.py",
    "kernels/flash_attention/ops.py",
    "kernels/flash_attention/ref.py",
    "kernels/grib_pack/__init__.py",
    "kernels/grib_pack/kernel.py",
    "kernels/grib_pack/ops.py",
    "kernels/grib_pack/ref.py",
    "kernels/ssd_scan/__init__.py",
    "kernels/ssd_scan/kernel.py",
    "kernels/ssd_scan/ops.py",
    "kernels/ssd_scan/ref.py",
    "models/__init__.py",
    "models/init.py",
    "models/model.py",
    "models/moe.py",
    "models/ops.py",
    "models/scan.py",
    "models/ssm.py",
    "roofline/__init__.py",
    "roofline/analysis.py",
    "roofline/codec.py",
    "serving/__init__.py",
    "serving/engine.py",
    "training/__init__.py",
    "training/loop.py",
    "training/optimizer.py",
)

_REBASE = re.compile(r"^(\s*)(from|import) repro(?=[.\s])", re.M)

BENCH = SRC.parent / "benchmarks"

#: benchmark twins: copies of a reference benchmark that drive the port
#: (twin -> reference, both under benchmarks/)
TWINS = {
    "ckpt_overlap_torch.py": "ckpt_overlap.py",
    "fdb_hammer_torch.py": "fdb_hammer.py",
    "figures_torch.py": "figures.py",
    "roofline_table_torch.py": "roofline_table.py",
    "run_torch.py": "run.py",
}


def _replace(old: str, new: str):
    def apply(text: str) -> str:
        return text.replace(old, new)

    return apply


def _top_level(text: str, func: str) -> tuple[int, int]:
    """Where the top-level ``def func`` lies in ``text``: from its line to
    the next top-level ``def``, or to the end."""
    start = text.index(f"\ndef {func}(") + 1
    end = text.find("\ndef ", start)
    return start, len(text) if end < 0 else end + 1


def _own(twin: str, func: str):
    """The reference's top-level ``func`` replaced by the twin's own, for a
    function the twin rewrites whole."""
    def apply(text: str) -> str:
        own = (BENCH / twin).read_text()
        a, b = _top_level(own, func)
        start, end = _top_level(text, func)
        return text[:start] + own[a:b] + text[end:]

    return apply


RUN_TORCH_DOC = """\
per-figure CSVs under artifacts/bench_torch/.  Roofline terms come from
the port's dry-run records if present (artifacts/dryrun_torch).

    PYTHONPATH=src python benchmarks/run_torch.py [--device cuda|cpu]

``--device`` (default ``cuda``) is where the port runs.  bench_kernels times
the plain PyTorch versions at the reference's shapes under its line names;
on the card each is followed by a line for the hand-written kernel at the
same shape, naming the instance that ran and its launch count."""

#: the named differences a twin may have beyond the rebased imports
ALLOWED = {
    "fdb_hammer_torch.py": [
        ("usage lines run the twin",
         _replace("benchmarks/fdb_hammer.py", "benchmarks/fdb_hammer_torch.py")),
        ("the twin writes its own output file, not the reference's",
         _replace("BENCH_contention.json", "BENCH_contention_torch.json")),
        ("the codec packs in a CUDA kernel on the card",
         _replace("``grib_pack`` Pallas launch", "``grib_pack`` CUDA launch")),
        ("the parent holds a CUDA context",
         _replace("the parent holds JAX thread pools and an\n    asyncio loop",
                  "the parent holds a CUDA context and an\n    asyncio loop")),
    ],
    "figures_torch.py": [
        ("imports the hammer twin", _replace("from .fdb_hammer import", "from .fdb_hammer_torch import")),
        ("writes its CSVs beside the reference's, not over them",
         _replace('"artifacts", "bench")', '"artifacts", "bench_torch")')),
    ],
    "roofline_table_torch.py": [
        ("reads the port's dry-run records (artifacts/dryrun_torch), never the TPU meshes' ones",
         _replace("dryrun", "dryrun_torch")),
    ],
    "run_torch.py": [
        ("the docstring names the twin's outputs, its dry-run records, --device and the kernel lines",
         _replace("per-figure CSVs under artifacts/bench/.  Roofline terms come from the\n"
                  "dry-run artifacts if present (artifacts/dryrun).", RUN_TORCH_DOC)),
        ("imports the figures twin", _replace("from . import figures\n", "from . import figures_torch as figures\n")),
        ("imports the checkpoint-overlap twin", _replace("from .ckpt_overlap import", "from .ckpt_overlap_torch import")),
        ("imports the roofline table twin", _replace("from .roofline_table import", "from .roofline_table_torch import")),
        ("bench_kernels times the port's plain versions, and on the card its kernels, on --device",
         _own("run_torch.py", "bench_kernels")),
        ("main takes --device, and the file runs as a script", _own("run_torch.py", "main")),
    ],
}


def twin_text(twin: str) -> str:
    """What ``benchmarks/<twin>`` must hold: its reference with the imports
    rebased and every allowed difference applied."""
    expected = _REBASE.sub(r"\1\2 repro_torch", (BENCH / TWINS[twin]).read_text())
    for name, apply in ALLOWED.get(twin, ()):
        changed = apply(expected)
        assert changed != expected, f"allow-list entry {name!r} no longer applies to {twin}"
        expected = changed
    return expected


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_module_equals_reference(rel):
    expected = _REBASE.sub(r"\1\2 repro_torch", (REF / rel).read_text())
    assert (PORT / rel).read_text() == expected, (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: copy the reference "
        "again, or move the module to PORTED if it is now a real port"
    )


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_benchmark_twin_equals_reference(twin):
    assert (BENCH / twin).read_text() == twin_text(twin), (
        f"benchmarks/{twin} drifted from benchmarks/{TWINS[twin]}: copy the "
        "reference again, or name the difference in ALLOWED"
    )


def test_every_counterpart_is_carried_or_ported():
    ours = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    counterparts = {rel for rel in ours if (REF / rel).exists()}
    assert counterparts == set(CARRIED) | set(PORTED)


def test_only_the_contention_import_is_rebased():
    rebased = [rel for rel in CARRIED if _REBASE.search((REF / rel).read_text())]
    assert rebased == ["metrics/contention.py", "simulation/cluster.py"]
