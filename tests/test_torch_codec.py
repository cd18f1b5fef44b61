"""The port's GRIB codec on the wire path (repro_torch.core.codec) against the
reference (repro.core.codec): the same wire format byte for byte, payloads
that interchange in both directions, the launch-count contract and the
device rule.  Inputs are made with numpy from a seed and go through both
packages; the port runs on the CPU, the reference in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from proptest import Rand, forall  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import grib_pack as tgp  # noqa: E402
from repro_torch.kernels.grib_pack.ref import unpack_ref  # noqa: E402

NBITS_SWEEP = (8, 16, 24)
NBITS_ALL = (1, 8, 16, 24, 31)


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


def body(p: bytes, nbits: int) -> np.ndarray:
    return np.frombuffer(p, dtype=tcodec.payload_dtype(nbits),
                         offset=tcodec.CODEC_HEADER_SIZE).astype(np.int64)


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

class TestWireFormat:
    def test_constants_match_reference(self):
        assert tcodec.CODEC_HEADER_SIZE == jcodec.CODEC_HEADER_SIZE == 32
        assert tcodec._HEADER_FMT == jcodec._HEADER_FMT
        for nbits in range(1, 33):
            assert tcodec.wire_size((7, 9), nbits) == jcodec.wire_size((7, 9), nbits)

    def test_header_roundtrip(self):
        fields = temperature_fields(np.random.default_rng(5), 3, 16, 128)
        for nbits in NBITS_SWEEP:
            for p in tcodec.encode_fields(fields, nbits=nbits):
                assert tcodec.is_codec_payload(p)
                hdr = tcodec.parse_header(p)
                assert (hdr.nbits, hdr.height, hdr.width) == (nbits, 16, 128)
                assert len(p) == tcodec.wire_size((16, 128), nbits)

    def test_raw_truncated_and_misframed_payloads(self):
        assert not tcodec.is_codec_payload(b"plain GRIB-less bytes, long enough to check")
        with pytest.raises(tcodec.CodecError, match="archived raw"):
            tcodec.parse_header(b"x" * 100)
        with pytest.raises(tcodec.CodecError, match="shorter than"):
            tcodec.parse_header(b"GRPK")
        p = tcodec.encode_fields(temperature_fields(np.random.default_rng(6), 1, 8, 128))[0]
        with pytest.raises(tcodec.CodecError, match="carries"):
            tcodec.parse_header(p[:-4])
        with pytest.raises(tcodec.CodecError, match="version"):
            tcodec.parse_header(p[:4] + b"\x09" + p[5:])
        with pytest.raises(tcodec.CodecError, match="step=42"):
            tcodec.parse_header(b"y" * 100, context="step=42")


# ---------------------------------------------------------------------------
# payloads interchange with the reference, in both directions
# ---------------------------------------------------------------------------

class TestInterchange:
    @pytest.mark.parametrize("nbits", NBITS_ALL)
    def test_headers_byte_identical_codes_within_one(self, nbits):
        fields = temperature_fields(np.random.default_rng(30 + nbits), 3, 16, 128)
        ours = tcodec.encode_fields(fields, nbits=nbits)
        theirs = jcodec.encode_fields(fields, nbits=nbits)
        for a, b in zip(ours, theirs):
            assert len(a) == len(b)
            assert a[:tcodec.CODEC_HEADER_SIZE] == b[:jcodec.CODEC_HEADER_SIZE]
            assert np.abs(body(a, nbits) - body(b, nbits)).max() <= 1

    @pytest.mark.parametrize("nbits", NBITS_ALL)
    def test_reference_payloads_decode_in_port(self, nbits):
        fields = temperature_fields(np.random.default_rng(40 + nbits), 3, 16, 128)
        decoded = tcodec.decode_payloads(jcodec.encode_fields(fields, nbits=nbits))
        for x, y in zip(fields, decoded):
            assert y.dtype == np.float32 and y.shape == x.shape
            assert np.max(np.abs(y - x)) <= quantum_bound(x, nbits)

    @pytest.mark.parametrize("nbits", NBITS_ALL)
    def test_port_payloads_decode_in_reference(self, nbits):
        fields = temperature_fields(np.random.default_rng(50 + nbits), 3, 16, 128)
        decoded = jcodec.decode_payloads(tcodec.encode_fields(fields, nbits=nbits))
        for x, y in zip(fields, decoded):
            assert np.max(np.abs(np.asarray(y) - x)) <= quantum_bound(x, nbits)

    def test_same_payload_decodes_alike_in_both(self):
        # decode is codes·scale + ref in both; XLA may fuse an FMA, so 1 ulp
        payloads = jcodec.encode_fields(temperature_fields(np.random.default_rng(7), 2, 16, 128))
        for a, b in zip(tcodec.decode_payloads(payloads), jcodec.decode_payloads(payloads)):
            b = np.asarray(b)
            assert np.all(np.abs(a - b) <= np.spacing(np.abs(b)))

    def test_constant_field(self):
        x = np.full((1, 8, 128), 5.0, np.float32)
        ours, theirs = tcodec.encode_fields(x)[0], jcodec.encode_fields(x)[0]
        assert ours == theirs
        np.testing.assert_allclose(tcodec.decode_payloads([theirs])[0], 5.0, atol=1e-5)

    def test_nbits_32_overflows_in_both_packages(self):
        x = temperature_fields(np.random.default_rng(8), 1, 4, 8)
        with pytest.raises(OverflowError):
            jcodec.encode_fields(x, nbits=32)
        with pytest.raises(OverflowError):
            tcodec.encode_fields(x, nbits=32)


# ---------------------------------------------------------------------------
# batch encode/decode: one launch per shape group, bit-stable decode
# ---------------------------------------------------------------------------

class TestEncodeDecode:
    def test_one_pack_launch_per_uniform_batch(self):
        fields = temperature_fields(np.random.default_rng(7), 9, 16, 128)
        tcodec.reset_kernel_launches()
        tcodec.encode_fields(fields, nbits=16)
        assert tcodec.kernel_launches() == {"pack": 1, "unpack": 0}

    def test_one_launch_per_shape_group_when_ragged(self):
        rng = np.random.default_rng(8)
        ragged = [temperature_fields(rng, 1, 8, 128)[0] for _ in range(3)]
        ragged += [temperature_fields(rng, 1, 16, 128)[0] for _ in range(2)]
        tcodec.reset_kernel_launches()
        tgp.reset_kernel_launches()
        payloads = tcodec.encode_fields(ragged)
        assert tcodec.kernel_launches()["pack"] == 2
        tcodec.reset_kernel_launches()
        tcodec.decode_payloads(payloads)
        assert tcodec.kernel_launches()["unpack"] == 2
        # on the CPU the plain version runs: no CUDA kernel was launched
        assert tgp.KERNEL_LAUNCHES == {"grib_pack": 0, "grib_unpack": 0}

    def test_decode_is_batchsplit_independent(self):
        payloads = tcodec.encode_fields(temperature_fields(np.random.default_rng(9), 6, 16, 128))
        whole = tcodec.decode_payloads(payloads)
        split = [tcodec.decode_payloads([p])[0] for p in payloads]
        for a, b in zip(whole, split):
            assert np.array_equal(a, b)

    def test_decode_matches_plain_unpack_of_stored_codes_exactly(self):
        payloads = tcodec.encode_fields(temperature_fields(np.random.default_rng(10), 4, 16, 128))
        for p, d in zip(payloads, tcodec.decode_payloads(payloads)):
            hdr = tcodec.parse_header(p)
            codes = body(p, hdr.nbits).reshape(1, hdr.height, hdr.width).astype(np.int32)
            oracle = unpack_ref(
                torch.from_numpy(codes),
                torch.tensor([hdr.ref], dtype=torch.float32),
                torch.tensor([hdr.scale], dtype=torch.float32),
            )[0].numpy()
            assert np.array_equal(d, oracle)

    def test_none_passthrough_and_empty(self):
        assert tcodec.encode_fields([]) == []
        assert tcodec.decode_payloads([]) == []
        p = tcodec.encode_fields(temperature_fields(np.random.default_rng(12), 1, 8, 128))[0]
        out = tcodec.decode_payloads([None, p, None])
        assert out[0] is None and out[2] is None and out[1] is not None

    @forall()
    def test_roundtrip_error_within_quantum(self, r: Rand):
        nbits = r.choice(NBITS_ALL)
        x = (r.floats((r.int(1, 4), r.int(1, 24), 128), scale=40.0) + 250.0).astype(np.float32)
        decoded = tcodec.decode_payloads(tcodec.encode_fields(x, nbits=nbits))
        for i in range(x.shape[0]):
            err = np.max(np.abs(decoded[i] - x[i]))
            assert err <= quantum_bound(x[i], nbits), f"nbits={nbits} err={err}"

    def test_tensor_and_array_batches_encode_alike(self):
        x = temperature_fields(np.random.default_rng(13), 4, 8, 128)
        want = tcodec.encode_fields(x)
        assert tcodec.encode_fields(torch.from_numpy(x)) == want
        assert tcodec.encode_fields([torch.from_numpy(f) for f in x]) == want
        assert tcodec.encode_fields(list(x.astype(np.float64))) == want

    def test_traced_codec_records_each_step_inside_its_launch_span(self):
        from repro_torch.obs.tracer import Tracer

        x = temperature_fields(np.random.default_rng(15), 3, 8, 128)
        tr = Tracer()
        payloads = tcodec.encode_fields(x, tracer=tr)
        decoded = tcodec.decode_payloads(payloads, tracer=tr)
        assert payloads == tcodec.encode_fields(x)  # tracing changes no byte
        for a, b in zip(decoded, tcodec.decode_payloads(payloads)):
            assert np.array_equal(a, b)
        spans = tr.spans()
        steps = {
            "pack": ["gather", "kernel", "to_host", "narrow", "frame"],
            "unpack": ["widen", "to_card", "kernel", "to_host"],
        }
        for side, names in steps.items():
            (parent,) = [s for s in spans if s.name == f"codec.{side}"]
            children = [s for s in spans if s.parent_id == parent.span_id]
            assert [s.name for s in children] == [f"codec.{side}.{n}" for n in names]
            assert sum(s.duration_s for s in children) <= parent.duration_s

    def test_take_fields_all_forms(self):
        arr = temperature_fields(np.random.default_rng(13), 4, 8, 128)
        assert np.array_equal(tcodec.take_fields(arr, [2, 0])[0], arr[2])
        assert np.array_equal(tcodec.take_fields([arr[i] for i in range(4)], [3])[0], arr[3])
        t = tcodec.take_fields(torch.from_numpy(arr), [1, 3])
        assert isinstance(t, torch.Tensor) and np.array_equal(t[1].numpy(), arr[3])


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

class TestDeviceRule:
    def test_codec_raises_without_cuda_unless_cpu_is_asked_for(self):
        if torch.cuda.is_available():
            pytest.skip("this case needs a machine without CUDA")
        x = temperature_fields(np.random.default_rng(14), 2, 8, 16)
        payloads = tcodec.encode_fields(x)  # the autouse fixture asked for the CPU
        set_default_device("cuda")  # as a caller that asked for nothing
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcodec.encode_fields(x)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcodec.decode_payloads(payloads)
        # a per-call request for the CPU works whatever the default
        assert tcodec.encode_fields(x, device="cpu") == payloads
