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
}


def _replace(old: str, new: str):
    def apply(text: str) -> str:
        return text.replace(old, new)

    return apply


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
