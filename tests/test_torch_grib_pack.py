"""Parity of the port's GRIB pack/unpack (repro_torch.kernels.grib_pack) with
the reference (repro.kernels.grib_pack): the same numpy inputs go through
both packages.  On the CPU the port runs its plain PyTorch version; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
The CUDA kernels are held against the plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import grib_pack as jgp  # noqa: E402
from repro.kernels.grib_pack import ref as jref  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import grib_pack as tgp  # noqa: E402
from repro_torch.kernels.grib_pack import kernel as tkernel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels.grib_pack import ref as tref  # noqa: E402

NBITS_ALL = (1, 8, 16, 24, 31)
NBITS_SWEEP = (8, 16, 24)

#: the reference's stats as its wire path computes them: under jit, where
#: XLA folds ``/ maxcode`` into a multiply by the float32 reciprocal
jit_field_stats = jax.jit(jref.field_stats, static_argnums=1)


@pytest.fixture(autouse=True)
def on_cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def temperature_fields(rng, f, h, w):
    return (rng.standard_normal((f, h, w)) * 40 + 250).astype(np.float32)


def as_np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def ulp_of(x: np.ndarray) -> np.float32:
    return np.spacing(np.float32(np.max(np.abs(x))))


# ---------------------------------------------------------------------------
# field_stats: ref/scale/inv_scale bit-equal to the reference's wire path
# ---------------------------------------------------------------------------

def assert_bit_equal(ours, theirs, what=""):
    for a, b in zip(ours, theirs):
        a, b = as_np(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32, what
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


class TestFieldStats:
    @pytest.mark.parametrize("nbits", NBITS_ALL)
    def test_bit_equal_to_reference(self, nbits):
        x = temperature_fields(np.random.default_rng(nbits), 4, 16, 128)
        t = tref.field_stats(torch.from_numpy(x), nbits)
        assert_bit_equal(t, jit_field_stats(jnp.asarray(x), nbits))
        # and to the ref/scale that the reference's grib_pack hands the codec
        _, tr, ts = tgp.grib_pack(x, nbits=nbits)
        _, jr, js = jgp.grib_pack(jnp.asarray(x), nbits=nbits)
        assert_bit_equal((tr, ts), (jr, js))

    def test_constant_field_uses_the_floor_span(self):
        x = np.full((2, 8, 16), 5.0, np.float32)
        t = tref.field_stats(torch.from_numpy(x), 16)
        assert_bit_equal(t, jit_field_stats(jnp.asarray(x), 16))

    @pytest.mark.parametrize("seed", range(4))
    def test_bit_equal_on_awkward_spans(self, seed):
        # spans over twelve decades, every width the reference's int32 takes
        rng = np.random.default_rng(100 + seed)
        x = (rng.standard_normal((4, 4, 32)) * 10.0 ** rng.integers(-6, 6)).astype(np.float32)
        for nbits in range(1, 32):
            t = tref.field_stats(torch.from_numpy(x), nbits)
            assert_bit_equal(t, jit_field_stats(jnp.asarray(x), nbits), nbits)

    def test_unjitted_reference_divides_truly(self):
        # a reference fact, pinned: outside jit, field_stats divides the span
        # by maxcode, which for span 3 at nbits=8 lands one ulp below the
        # jitted wire path's multiply by fl32(1/255); the port follows the
        # wire path, so its headers equal the reference's encode_fields
        x = np.asarray([[[0.0, 3.0]]], np.float32)
        _, eager, _ = jref.field_stats(jnp.asarray(x), 8)
        _, jitted, _ = jit_field_stats(jnp.asarray(x), 8)
        _, ours, _ = tref.field_stats(torch.from_numpy(x), 8)
        e, j = np.asarray(eager).view(np.int32), np.asarray(jitted).view(np.int32)
        assert (j - e).tolist() == [1]
        assert np.array_equal(as_np(ours).view(np.int32), j)

    def test_nbits_32_overflows_in_both_packages(self):
        x = temperature_fields(np.random.default_rng(0), 1, 4, 8)
        with pytest.raises(OverflowError):
            jgp.grib_pack(jnp.asarray(x), nbits=32)
        with pytest.raises(OverflowError):
            tgp.grib_pack(x, nbits=32)
        # yet the container accepts 32 in both
        assert jgp.payload_dtype(32) == tgp.payload_dtype(32) == np.uint32


# ---------------------------------------------------------------------------
# pack: codes equal to the reference's pack_ref, within ±1 of its kernel
# ---------------------------------------------------------------------------

class TestPack:
    @pytest.mark.parametrize("nbits", NBITS_ALL)
    def test_codes_equal_reference_pack_ref(self, nbits):
        x = temperature_fields(np.random.default_rng(10 + nbits), 3, 16, 128)
        lo, _, inv = jit_field_stats(jnp.asarray(x), nbits)
        expected = np.asarray(jref.pack_ref(jnp.asarray(x), lo, inv, nbits))
        codes, _, _ = tgp.grib_pack(x, nbits=nbits)
        assert codes.dtype == torch.int32
        assert np.array_equal(as_np(codes), expected)
        # the plain version on the same stats, whatever computed them
        lo, _, inv = jref.field_stats(jnp.asarray(x), nbits)
        ours = tref.pack_ref(torch.from_numpy(x), torch.from_numpy(np.array(lo)),
                             torch.from_numpy(np.array(inv)), nbits)
        assert np.array_equal(as_np(ours), np.asarray(jref.pack_ref(jnp.asarray(x), lo, inv, nbits)))

    @pytest.mark.parametrize("shape", [(1, 32, 128), (4, 64, 128), (2, 256, 256)])
    @pytest.mark.parametrize("nbits", (8, 16))
    def test_codes_within_one_of_reference_kernel(self, shape, nbits):
        x = temperature_fields(np.random.default_rng(sum(shape)), *shape)
        jcodes, jr, js = jgp.grib_pack(jnp.asarray(x), nbits=nbits, interpret=True)
        tcodes, tr, ts = tgp.grib_pack(x, nbits=nbits)
        # rounding boundaries can flip ±1 code (tests/test_kernels.py precedent)
        assert np.abs(as_np(tcodes).astype(np.int64) - np.asarray(jcodes)).max() <= 1
        assert np.array_equal(as_np(tr), np.asarray(jr))
        assert np.array_equal(as_np(ts), np.asarray(js))

    def test_31_bit_clip_bound_saturates_like_xla(self):
        # at nbits=31 the float32 clip bound is 2^31; XLA saturates it to
        # INT32_MAX, and so must the port (torch's CPU cast would wrap it)
        x = np.asarray([[[0.0, 1.0, 0.5, 1.0]]], np.float32)
        jcodes, _, _ = jgp.grib_pack(jnp.asarray(x), nbits=31, interpret=True)
        tcodes, _, _ = tgp.grib_pack(x, nbits=31)
        assert np.array_equal(as_np(tcodes), np.asarray(jcodes))
        assert as_np(tcodes).max() == np.iinfo(np.int32).max

    def test_half_to_even_rounding(self):
        # (x - ref) * inv_scale lands exactly on .5: jnp.round and the port
        # both round half to even (2.5 -> 2, 3.5 -> 4)
        x = np.asarray([[[0.0, 2.5, 3.5, 7.0]]], np.float32)
        ref = torch.tensor([0.0])
        inv = torch.tensor([1.0])
        codes = tref.pack_ref(torch.from_numpy(x), ref, inv, nbits=8)
        j = jref.pack_ref(jnp.asarray(x), jnp.asarray([0.0]), jnp.asarray([1.0]), nbits=8)
        assert as_np(codes).tolist() == [[[0, 2, 4, 7]]] == np.asarray(j).tolist()


# ---------------------------------------------------------------------------
# unpack and the round trip
# ---------------------------------------------------------------------------

class TestUnpack:
    @pytest.mark.parametrize("nbits", NBITS_ALL)
    def test_unpack_within_one_ulp_of_reference(self, nbits):
        # the port rounds product and sum apart; XLA on the CPU may contract
        # them into one FMA, so the two agree to 1 ulp of the output
        x = temperature_fields(np.random.default_rng(20 + nbits), 2, 16, 128)
        codes, ref, scale = tgp.grib_pack(x, nbits=nbits)
        t = as_np(tgp.grib_unpack(codes, ref, scale))
        j = np.asarray(jgp.grib_unpack(
            jnp.asarray(as_np(codes)), jnp.asarray(as_np(ref)), jnp.asarray(as_np(scale)),
            interpret=True,
        ))
        assert np.all(np.abs(t - j) <= np.spacing(np.abs(j)))
        jr = np.asarray(jref.unpack_ref(
            jnp.asarray(as_np(codes)), jnp.asarray(as_np(ref)), jnp.asarray(as_np(scale))
        ))
        assert np.all(np.abs(t - jr) <= np.spacing(np.abs(jr)))

    @pytest.mark.parametrize("nbits", NBITS_ALL)
    @pytest.mark.parametrize("shape", [(1, 32, 128), (4, 64, 128), (2, 37, 45)])
    def test_roundtrip_within_quantum(self, shape, nbits):
        x = temperature_fields(np.random.default_rng(nbits * 7 + shape[1]), *shape)
        codes, ref, scale = tgp.grib_pack(x, nbits=nbits)
        y = as_np(tgp.grib_unpack(codes, ref, scale))
        quantum = np.maximum(x.max(axis=(1, 2)) - x.min(axis=(1, 2)), 1e-30) / ((1 << nbits) - 1)
        for i in range(shape[0]):
            err = np.max(np.abs(y[i] - x[i]))
            assert err <= quantum[i] * 1.01 + 2 * ulp_of(x[i]), f"nbits={nbits} err={err}"

    def test_constant_field(self):
        x = np.full((1, 32, 128), 5.0, np.float32)
        codes, ref, scale = tgp.grib_pack(x)
        y = as_np(tgp.grib_unpack(codes, ref, scale))
        np.testing.assert_allclose(y, 5.0, atol=1e-5)
        assert as_np(codes).max() == 0


# ---------------------------------------------------------------------------
# pack_to_bytes / unpack_from_bytes (the reference's test_codec.py sweep)
# ---------------------------------------------------------------------------

class TestPackToBytes:
    @pytest.mark.parametrize("nbits", NBITS_SWEEP)
    def test_payload_width_follows_nbits(self, nbits):
        x = temperature_fields(np.random.default_rng(0), 1, 16, 128)[0]
        payload, meta = tgp.pack_to_bytes(x, nbits=nbits)
        dtype = tgp.payload_dtype(nbits)
        assert meta["nbits"] == nbits
        assert meta["dtype"] == dtype.name
        assert len(payload) == x.size * dtype.itemsize

    @pytest.mark.parametrize("nbits", NBITS_SWEEP)
    def test_bytes_and_meta_interchange_with_reference(self, nbits):
        x = temperature_fields(np.random.default_rng(1), 1, 8, 128)[0]
        jp, jm = jgp.pack_to_bytes(x, nbits=nbits)
        tp, tm = tgp.pack_to_bytes(x, nbits=nbits)
        assert (tm["ref"], tm["scale"], tm["dtype"]) == (jm["ref"], jm["scale"], jm["dtype"])
        jc = np.frombuffer(jp, dtype=jgp.payload_dtype(nbits)).astype(np.int64)
        tc = np.frombuffer(tp, dtype=tgp.payload_dtype(nbits)).astype(np.int64)
        assert np.abs(jc - tc).max() <= 1
        quantum = (x.max() - x.min()) / ((1 << nbits) - 1)
        for y in (tgp.unpack_from_bytes(jp, jm), np.asarray(jgp.unpack_from_bytes(tp, tm))):
            assert np.max(np.abs(y - x)) <= quantum * 1.01 + 2 * ulp_of(x)

    def test_distinct_nbits_distinct_sizes(self):
        x = temperature_fields(np.random.default_rng(1), 1, 8, 128)[0]
        sizes = {n: len(tgp.pack_to_bytes(x, nbits=n)[0]) for n in NBITS_SWEEP}
        assert sizes[8] < sizes[16] < sizes[24]

    @pytest.mark.parametrize("nbits", NBITS_SWEEP)
    def test_roundtrip_within_quantum(self, nbits):
        x = temperature_fields(np.random.default_rng(2), 1, 32, 128)[0]
        payload, meta = tgp.pack_to_bytes(x, nbits=nbits)
        y = tgp.unpack_from_bytes(payload, meta)
        quantum = (x.max() - x.min()) / ((1 << nbits) - 1)
        # at 24 bits the quantum drops below the float32 ulp of the values
        assert np.max(np.abs(y - x)) <= quantum * 1.01 + 2 * ulp_of(x)

    def test_unpack_rejects_mismatched_payload(self):
        x = temperature_fields(np.random.default_rng(3), 1, 8, 128)[0]
        payload, meta = tgp.pack_to_bytes(x, nbits=16)
        with pytest.raises(ValueError, match="do not belong together"):
            tgp.unpack_from_bytes(payload[:-2], meta)
        with pytest.raises(ValueError, match="do not belong together"):
            tgp.unpack_from_bytes(payload, dict(meta, shape=(4, 128)))

    def test_unpack_legacy_meta_without_dtype(self):
        x = temperature_fields(np.random.default_rng(4), 1, 8, 128)[0]
        payload, meta = tgp.pack_to_bytes(x, nbits=8)
        del meta["dtype"]
        assert tgp.unpack_from_bytes(payload, meta).shape == x.shape

    def test_payload_dtype_containers(self):
        for nbits in range(1, 33):
            assert tgp.payload_dtype(nbits) == jgp.payload_dtype(nbits)
        for bad in (0, 33, 8.0):
            with pytest.raises(ValueError):
                tgp.payload_dtype(bad)


# ---------------------------------------------------------------------------
# dispatch, launch counting and the build (no card needed)
# ---------------------------------------------------------------------------

class TestDispatch:
    def test_cpu_tensors_take_the_plain_version_uncounted(self):
        launches.reset()
        x = temperature_fields(np.random.default_rng(5), 2, 8, 16)
        codes, ref, scale = tgp.grib_pack(x)
        tgp.grib_unpack(codes, ref, scale)
        assert codes.device.type == "cpu"
        assert launches.snapshot() == {}

    def test_without_cuda_the_default_device_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this case needs a machine without CUDA")
        set_default_device("cuda")
        x = temperature_fields(np.random.default_rng(6), 1, 4, 8)
        with pytest.raises(RuntimeError, match="set_default_device\\('cpu'\\)"):
            tgp.grib_pack(x)
        # an explicit per-call request for the CPU still works
        codes, _, _ = tgp.grib_pack(x, device="cpu")
        assert codes.device.type == "cpu"

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        # the CUDA entry points never fall back to the plain version
        x = torch.zeros((1, 4, 8))
        r = torch.zeros(1)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tkernel.grib_pack_call(x, r, r, nbits=8)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tkernel.grib_unpack_call(x.to(torch.int32), r, r)

    def test_build_names_a_missing_compiler(self, monkeypatch, tmp_path):
        monkeypatch.setattr(tkernel.LIBRARY, "build_dir", tmp_path)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
        with pytest.raises(RuntimeError, match="not found"):
            tkernel.LIBRARY.build()
        assert list(tmp_path.iterdir()) == []

    def test_library_is_keyed_by_the_source(self, monkeypatch, tmp_path):
        a = tkernel.LIBRARY.path()
        assert a == tkernel.LIBRARY.path()
        assert a.name.startswith("libgrib_pack_") and a.parent == _build.BUILD_DIR
        src = tmp_path / "grib_pack.cu"
        src.write_bytes(tkernel.LIBRARY.source.read_bytes() + b"\n// edited\n")
        monkeypatch.setattr(tkernel.LIBRARY, "source", src)
        assert tkernel.LIBRARY.path() != a
