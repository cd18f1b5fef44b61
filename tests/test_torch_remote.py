"""The port's wire transport (repro_torch.core.remote) against the reference's
(repro.core.remote), in one process: a port client against a reference
server and a reference client against a port server.  Raw payloads come back
byte for byte; fields that one package's client packs before the wire
decode in the other's within the quantum, under the same 32-byte GRPK
header; and ``{"type": "remote"}`` config trees build in the port.  Inputs
are made with numpy from a seed; the port runs on the CPU, the reference's
codec in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core import remote as jremote  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.core import remote as tremote  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402

#: (server package, client package): each package's client against the
#: other package's server
PAIRS = [
    pytest.param(((jcore, jremote), (tcore, tremote)), id="torch_client_repro_server"),
    pytest.param(((tcore, tremote), (jcore, jremote)), id="repro_client_torch_server"),
]


@pytest.fixture(autouse=True)
def on_cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def temperature_fields(rng, f, h, w):
    return (rng.standard_normal((f, h, w)) * 40 + 250).astype(np.float32)


def quantum_bound(x: np.ndarray, nbits: int) -> float:
    """The round-trip bound of one field: quantum·1.01 + 2 ulp."""
    quantum = max(float(x.max() - x.min()), 1e-30) / ((1 << nbits) - 1)
    return quantum * 1.01 + 2 * float(np.spacing(np.float32(np.max(np.abs(x)))))


def field_key(core, step: int, param: str):
    return core.Key({"class": "od", "stream": "oper", "expver": "0001", "date": "20240603",
                     "time": "1200", "type": "ef", "levtype": "sfc", "number": "0",
                     "levelist": "0", "step": str(step), "param": param})


@pytest.fixture(params=PAIRS)
def pair(request, tmp_path):
    """A started server of one package over a POSIX tree, the other package's
    client connected to it, and a client of the server's own package."""
    (score, sremote), (ccore, cremote) = request.param
    server = sremote.FDBServer({"backend": "posix", "schema": "nwp-posix",
                                "root": str(tmp_path / "fdb")})
    host, port = server.start()
    client = cremote.RemoteFDB(f"{host}:{port}", timeout=30.0)
    native = sremote.RemoteFDB(f"{host}:{port}", timeout=30.0)
    try:
        yield ccore, client, score, native, server
    finally:
        client.close()
        native.close()
        server.stop()


def test_raw_payloads_read_back_byte_identical(pair):
    ccore, client, score, native, server = pair
    rng = np.random.default_rng(3)
    written = {}
    for step in range(3):
        for param in ("2t", "10u"):
            data = rng.bytes(int(rng.integers(1, 5000)))
            client.archive(field_key(ccore, step, param), data)
            written[(step, param)] = data
    client.flush()
    for (step, param), data in written.items():
        assert client.read(field_key(ccore, step, param)) == data
        assert native.read(field_key(score, step, param)) == data
        assert server.fdb.read(field_key(score, step, param)) == data  # what landed
    got = client.read_batch([field_key(ccore, s, p) for s, p in written])
    assert got == list(written.values())


@pytest.mark.parametrize("nbits", (16, 24))
def test_fields_packed_before_the_wire_decode_in_the_other_package(pair, nbits):
    ccore, client, score, native, _ = pair
    fields = temperature_fields(np.random.default_rng(nbits), 4, 16, 128)
    params = ("2t", "10u", "10v", "msl")
    client.archive_fields([field_key(ccore, 0, p) for p in params], fields, nbits=nbits)
    client.flush()
    request = {**dict(field_key(ccore, 0, "2t")), "param": list(params)}
    for reader in (native, client):
        got = reader.retrieve_fields(request)
        assert len(got) == len(params)
        for k, arr in got.items():
            x = fields[params.index(k["param"])]
            assert np.max(np.abs(np.asarray(arr) - x)) <= quantum_bound(x, nbits)
    # the same 32-byte header either package's codec writes for these fields
    for p, x in zip(params, fields):
        payload = native.read(field_key(score, 0, p))
        for codec in (jcodec, tcodec):
            assert payload[:32] == codec.encode_fields(x[None], nbits=nbits)[0][:32]
        assert len(payload) == tcodec.wire_size(x.shape, nbits)


def test_remote_config_tree_builds_in_the_port(tmp_path):
    inner = {"backend": "posix", "schema": "nwp-posix", "root": str(tmp_path / "fdb")}
    fields = temperature_fields(np.random.default_rng(9), 2, 8, 128)
    keys = [field_key(tcore, 1, p) for p in ("2t", "10u")]
    with tcore.build_fdb({"type": "codec", "nbits": 16,
                          "inner": {"type": "remote", "inner": inner}}) as fdb:
        fdb.archive_fields(keys, fields)
        fdb.flush()
        arrays = fdb.retrieve_fields({**dict(keys[0]), "param": ["2t", "10u"]}).arrays()
        assert arrays.shape == fields.shape
        for x, y in zip(fields, arrays):
            assert np.max(np.abs(y - x)) <= quantum_bound(x, 16)
    # addr form against a reference server, inside a select tree
    server = jremote.FDBServer({"backend": "daos", "schema": "nwp-daos"})
    host, port = server.start()
    try:
        cfg = {"type": "select", "default": {"type": "remote", "addr": f"{host}:{port}"}}
        with tcore.build_fdb(cfg) as fdb:
            fdb.archive(keys[0], b"raw")
            fdb.flush()
            assert fdb.read(keys[0]) == b"raw"
        assert server.fdb.read(field_key(jcore, 1, "2t")) == b"raw"
    finally:
        server.stop()
    with pytest.raises(tcore.ConfigError, match="exactly one"):
        tcore.build_fdb({"type": "remote"})
