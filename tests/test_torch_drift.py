"""Every module the port carries over from the reference unchanged must stay
equal to it as text.  Allowed differences: absolute ``repro.`` imports
rebased to ``repro_torch.``, and the short named allow-list below.  The
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
    "models/ops.py",
    "models/ssm.py",
    "serving/__init__.py",
    "serving/engine.py",
    "training/__init__.py",
    "training/loop.py",
    "training/optimizer.py",
)

_REBASE = re.compile(r"^(\s*)(from|import) repro(?=[.\s])", re.M)


def _guard(node: str):
    """config.py: the ``elif t == "<node>":`` branch of validate_config
    becomes one ConfigError, because the node's package is not ported yet."""

    def apply(text: str) -> str:
        head = f'    elif t == "{node}":\n'
        start = text.index(head) + len(head)
        lines = text[start:].splitlines(keepends=True)
        n = 0
        while n < len(lines) and (lines[n].startswith(" " * 8) or not lines[n].strip()):
            n += 1
        while n and not lines[n - 1].strip():
            n -= 1  # trailing blank lines belong to what follows
        end = start + sum(len(line) for line in lines[:n])
        guard = f'        raise ConfigError("{node} config is not yet ported to repro_torch")\n'
        return text[:start] + guard + text[end:]

    return apply


def _drop_remote_exports(text: str) -> str:
    """core/__init__.py: ``core/remote`` comes in a later slice, so its names
    are not imported or exported."""
    text = re.sub(r"from \.remote import \([^)]*\)\n", "", text)
    for name in ("RemoteFDB", "FDBServer", "RemoteError", "RemoteTimeout", "serve_fdb"):
        text = text.replace(f'    "{name}",\n', "")
    return text


ALLOWED = {
    "core/config.py": [("remote node not yet ported", _guard("remote"))],
    "core/__init__.py": [("remote exports dropped", _drop_remote_exports)],
}


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_module_equals_reference(rel):
    expected = _REBASE.sub(r"\1\2 repro_torch", (REF / rel).read_text())
    for name, apply in ALLOWED.get(rel, ()):
        changed = apply(expected)
        assert changed != expected, f"allow-list entry {name!r} no longer applies to {rel}"
        expected = changed
    assert (PORT / rel).read_text() == expected, (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: copy the reference "
        "again, or move the module to PORTED if it is now a real port"
    )


def test_every_counterpart_is_carried_or_ported():
    ours = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    counterparts = {rel for rel in ours if (REF / rel).exists()}
    assert counterparts == set(CARRIED) | set(PORTED)


def test_only_the_contention_import_is_rebased():
    rebased = [rel for rel in CARRIED if _REBASE.search((REF / rel).read_text())]
    assert rebased == ["metrics/contention.py"]
