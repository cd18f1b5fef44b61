"""The port's main path on the CPU: build_fdb, archive_fields, flush and
retrieve_fields through both backends and the tiered codec deployment
(hot DAOS at 16 bits, cold POSIX at 24), POSIX roots that either package
writes and the other reads, and the port's independence from JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.codec import kernel_launches, parse_header, reset_kernel_launches  # noqa: E402
from repro_torch.core.daos import DaosEngine  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402

NBITS_SWEEP = (8, 16, 24)
SRC = Path(__file__).resolve().parents[1] / "src"

#: the tiered codec deployment of benchmarks/fdb_hammer.py (TIERED_CODEC_CONFIG)
TIERED_CODEC_CONFIG = {
    "type": "select",
    "rules": [
        {
            "match": "number=0",
            "fdb": {
                "type": "codec", "nbits": 16,
                "inner": {"backend": "daos", "schema": "nwp-daos"},
            },
        },
    ],
    "default": {
        "type": "codec", "nbits": 24,
        "inner": {"backend": "posix", "schema": "nwp-posix"},
    },
}


@pytest.fixture(autouse=True)
def on_cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def temperature_fields(rng, f, h, w):
    return (rng.standard_normal((f, h, w)) * 40 + 250).astype(np.float32)


def example_key(**over) -> tcore.Key:
    base = dict(
        **{"class": "od"}, stream="oper", expver="0001", date="20231201",
        time="1200", type="ef", levtype="sfc", number="1", levelist="1",
        step="1", param="v",
    )
    base.update(over)
    return tcore.Key(base)


def bound(x: np.ndarray, nbits: int) -> float:
    quantum = max(float(x.max() - x.min()), 1e-30) / ((1 << nbits) - 1)
    return quantum * 1.01 + 2 * float(np.spacing(np.float32(np.max(np.abs(x)))))


def tiered(tmp_path) -> dict:
    cfg = json.loads(json.dumps(TIERED_CODEC_CONFIG))
    cfg["default"]["inner"]["root"] = str(tmp_path / "cold")
    return cfg


@pytest.fixture(params=["daos", "posix"])
def fdb(request, tmp_path):
    if request.param == "daos":
        cfg = {"backend": "daos", "schema": "nwp-daos", "engine": DaosEngine()}
    else:
        cfg = {"backend": "posix", "schema": "nwp-posix", "root": str(tmp_path / "fdb")}
    with tcore.build_fdb(cfg) as client:
        yield client


# ---------------------------------------------------------------------------
# archive_fields / retrieve_fields through build_fdb on both backends
# ---------------------------------------------------------------------------

class TestClientRoundTrip:
    def _archive(self, fdb, nbits=None, steps=3, params=2):
        keys = [example_key(step=str(s), param=p)
                for s in range(steps) for p in ("u", "v", "t")[:params]]
        fields = temperature_fields(np.random.default_rng(42), len(keys), 16, 128)
        fdb.archive_fields(keys, fields, nbits=nbits)
        fdb.flush()
        return keys, fields

    @pytest.mark.parametrize("nbits", NBITS_SWEEP)
    def test_archive_retrieve_fields(self, fdb, nbits):
        keys, fields = self._archive(fdb, nbits=nbits)
        req = {**dict(example_key()), "step": [str(s) for s in range(3)], "param": ["u", "v"]}
        got = fdb.retrieve_fields(req)
        assert len(got) == len(keys)
        assert got.arrays().shape == fields.shape
        for k, a in got.items():
            i = keys.index(k)
            assert np.max(np.abs(a - fields[i])) <= bound(fields[i], nbits)

    def test_partial_retrieve_decodes_lazily_per_chunk(self, fdb):
        keys, _ = self._archive(fdb, steps=4, params=2)
        req = {**dict(example_key()), "step": ["0", "1", "2", "3"], "param": ["u", "v"]}
        decoded = fdb.retrieve_many(req).decode(chunk=2)
        reset_kernel_launches()
        assert decoded[keys[0]] is not None
        assert kernel_launches()["unpack"] == 1  # one chunk, one launch
        for k, a in fdb.retrieve_fields(req).read_all().items():
            assert np.array_equal(a, decoded[k])

    def test_missing_fields_pass_through_as_none(self, fdb):
        self._archive(fdb)
        got = fdb.retrieve_fields({**dict(example_key()), "step": ["0", "99"], "param": "u"})
        assert got.missing() == [example_key(step="99", param="u")]
        with pytest.raises(tcore.CodecError, match="absent"):
            got.arrays()

    def test_raw_and_codec_coexist(self, fdb):
        raw_key = example_key(param="q")
        fdb.archive(raw_key, b"raw-grib-payload" * 4)
        keys, _ = self._archive(fdb, steps=1, params=1)
        assert fdb.read(raw_key) == b"raw-grib-payload" * 4
        assert tcore.is_codec_payload(fdb.read(keys[0]))
        with pytest.raises(tcore.CodecError, match="archived raw"):
            fdb.retrieve_fields({**dict(raw_key)}).read_all()

    def test_effective_vs_wire_telemetry(self, fdb):
        keys, fields = self._archive(fdb, nbits=16)
        req = {**dict(example_key()), "step": [str(s) for s in range(3)], "param": ["u", "v"]}
        fdb.retrieve_fields(req).read_all()
        snap = fdb.stats_snapshot()
        assert snap["effective_bytes_written"] == fields.nbytes
        assert snap["effective_bytes_read"] == fields.nbytes
        assert fields.nbytes / (len(keys) * tcore.wire_size((16, 128), 16)) >= 1.5
        assert snap["ops"]["codec_pack"] == len(keys)
        assert snap["ops"]["codec_unpack"] == len(keys)

    def test_archive_fields_key_count_mismatch(self, fdb):
        fields = temperature_fields(np.random.default_rng(0), 2, 8, 128)
        with pytest.raises(ValueError, match="3 keys for 2"):
            fdb.archive_fields([example_key(), example_key(param="u"), example_key(param="t")],
                               fields)


# ---------------------------------------------------------------------------
# the tiered codec deployment and the codec config node
# ---------------------------------------------------------------------------

class TestTieredCodec:
    def test_one_call_two_tiers_two_widths(self, tmp_path):
        members, params = ("0", "3"), ("u", "v", "t")
        keys = [example_key(number=m, param=p) for m in members for p in params]
        fields = temperature_fields(np.random.default_rng(1), len(keys), 16, 128)
        with tcore.build_fdb(tiered(tmp_path)) as fdb:
            assert isinstance(fdb, tcore.SelectFDB)
            reset_kernel_launches()
            fdb.archive_fields(keys, fields)  # ONE call, routed then packed per tier
            assert kernel_launches()["pack"] == 2
            fdb.flush()
            for k in keys:
                assert parse_header(fdb.read(k)).nbits == (16 if k["number"] == "0" else 24)
            got = fdb.retrieve_fields({**dict(example_key()), "number": list(members),
                                       "param": list(params)})
            assert got.arrays().shape == fields.shape
            for k, a in got.items():
                i = keys.index(k)
                assert np.max(np.abs(a - fields[i])) <= bound(fields[i], 16 if k["number"] == "0" else 24)
            assert fdb.stats_snapshot()["effective_bytes_written"] == fields.nbytes

    def test_build_codec_node_and_json_roundtrip(self, tmp_path):
        cfg = tcore.FDBConfig({
            "type": "codec", "nbits": 8,
            "inner": {"backend": "posix", "schema": "nwp-posix", "root": str(tmp_path / "f")},
        })
        again = tcore.FDBConfig.from_json(cfg.to_json())
        assert again == cfg
        with again.build() as fdb:
            assert isinstance(fdb, tcore.CodecFDB) and fdb.nbits == 8
            keys = [example_key(param=p) for p in ("u", "v")]
            fdb.archive_fields(keys, temperature_fields(np.random.default_rng(0), 2, 8, 128))
            fdb.flush()
            assert parse_header(fdb.read(keys[0])).nbits == 8

    def test_validation_errors(self, tmp_path):
        with pytest.raises(tcore.ConfigError, match="requires 'inner'"):
            tcore.build_fdb({"type": "codec"})
        with pytest.raises(tcore.ConfigError, match="nbits"):
            tcore.build_fdb({"type": "codec", "nbits": 0,
                             "inner": {"backend": "posix", "schema": "nwp-posix", "root": "/x"}})
        with tcore.make_fdb("posix", schema=tcore.NWP_SCHEMA_POSIX, root=str(tmp_path / "f")) as inner:
            with pytest.raises(ValueError, match="nbits"):
                tcore.CodecFDB(inner, nbits=40)

    def test_async_facade_inherits_codec_width(self, tmp_path):
        inner = tcore.CodecFDB(
            tcore.make_fdb("posix", schema=tcore.NWP_SCHEMA_POSIX, root=str(tmp_path / "f")),
            nbits=8,
        )
        with tcore.AsyncFDB(inner, writers=1, owns_fdb=True) as afdb:
            assert afdb._codec_nbits == 8
            k = example_key()
            afdb.archive_fields([k], temperature_fields(np.random.default_rng(2), 1, 8, 128))
            afdb.flush()
            assert parse_header(afdb.read(k)).nbits == 8

    @pytest.mark.parametrize("node", [
        {"type": "remote", "addr": "127.0.0.1:1"},
    ])
    def test_unported_nodes_raise_config_error(self, node):
        with pytest.raises(tcore.ConfigError, match="not yet ported to repro_torch"):
            tcore.build_fdb(node)
        with pytest.raises(tcore.ConfigError, match="not yet ported to repro_torch"):
            tcore.build_fdb({"type": "select", "default": node})


# ---------------------------------------------------------------------------
# POSIX roots interchange between the packages
# ---------------------------------------------------------------------------

def _posix_codec(core, root, nbits):
    return core.build_fdb({"type": "codec", "nbits": nbits,
                           "inner": {"backend": "posix", "schema": "nwp-posix", "root": root}})


class TestPosixRootInterchange:
    @pytest.mark.parametrize("nbits", (16, 24))
    @pytest.mark.parametrize("writer,reader", [(jcore, tcore), (tcore, jcore)],
                             ids=["repro_to_torch", "torch_to_repro"])
    def test_root_written_by_one_is_read_by_the_other(self, tmp_path, writer, reader, nbits):
        root = str(tmp_path / "fdb")
        keys = [dict(example_key(step=str(s), param=p)) for s in range(2) for p in ("u", "v")]
        fields = temperature_fields(np.random.default_rng(nbits), len(keys), 12, 64)
        with _posix_codec(writer, root, nbits) as w:
            w.archive_fields(keys, fields)
            w.flush()
            written = {k["step"] + k["param"]: w.read(k) for k in keys}
        req = {**keys[0], "step": ["0", "1"], "param": ["u", "v"]}
        with _posix_codec(reader, root, nbits) as r:
            listed = sorted(sorted(dict(e.key).items()) for e in r.list(req))
            assert listed == sorted(sorted(k.items()) for k in keys)
            for k in keys:
                assert r.read(k) == written[k["step"] + k["param"]]  # field for field
            got = r.retrieve_fields(req)
            for k, a in got.items():
                i = [reader.Key(kk) for kk in keys].index(k)
                assert np.max(np.abs(np.asarray(a) - fields[i])) <= bound(fields[i], nbits)


# ---------------------------------------------------------------------------
# the port imports no JAX and nothing of repro
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.core, repro_torch.metrics, repro_torch.obs, repro_torch.fields\n"
        "import repro_torch.kernels.grib_pack, repro_torch.device\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
