"""The port's flash attention on the CPU, against the JAX package.

The plain PyTorch version (what the Hopper kernel computes) is held against
the reference's oracle ``attention_ref`` and against its Pallas kernel run in
interpret mode, on the same inputs made from a numpy seed, at the shapes of
``tests/test_kernels.py`` (tolerances 2e-4 in float32 and 2e-2 in bfloat16,
as there).  The wrapper's dispatch, launch counter and build helper are
checked here too; the kernel itself runs in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import KERNEL_LAUNCHES, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402

SHAPES = [  # b, sq, sk, kh, g, d (tests/test_kernels.py:28-34)
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 2, 3, 64),
    (1, 128, 384, 2, 2, 128),
    (2, 64, 64, 4, 1, 32),
]


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


def inputs(seed, b, sq, sk, kh, g, d, dtype="float32"):
    """q, k, v from a numpy seed, as (jax arrays, torch tensors) of one dtype."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((b, sq, kh, g, d), (b, sk, kh, d), (b, sk, kh, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,kh,g,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_oracle(b, sq, sk, kh, g, d, causal, dtype):
    (jq, jk, jv), (q, k, v) = inputs(0, b, sq, sk, kh, g, d, dtype)
    out = flash_attention(q, k, v, causal=causal)
    assert out.shape == (b, sq, kh, g, d) and out.dtype == q.dtype
    np.testing.assert_allclose(f32(out), f32(attention_ref(jq, jk, jv, causal=causal)), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,kh,g,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel_interpreted(b, sq, sk, kh, g, d, causal, dtype):
    (jq, jk, jv), (q, k, v) = inputs(1, b, sq, sk, kh, g, d, dtype)
    ref = jflash(jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(f32(flash_attention(q, k, v, causal=causal)), f32(ref), **tol(dtype))


def test_q_offset_window():
    """q_offset continues a causal stream mid-sequence (test_kernels.py:48-58)."""
    (jq, jk, jv), (q, k, v) = inputs(2, 1, 64, 192, 1, 1, 64)
    out = f32(flash_attention(q, k, v, causal=True, q_offset=128))
    ref = jflash(jq, jk, jv, causal=True, q_offset=128, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(out, f32(ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(out, f32(attention_ref(jq, jk, jv, causal=True, q_offset=128)),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("sq,sk,off", [(100, 100, 0), (37, 90, 53), (1, 70, 69)])
def test_ragged_lengths(sq, sk, off):
    """Lengths that are not multiples of the block.  Against the interpreted
    Pallas kernel only the query tail is ragged (its key block spans every
    key; see the next test for why), against the oracle both are."""
    (jq, jk, jv), (q, k, v) = inputs(3, 1, sq, sk, 2, 2, 32)
    out = f32(flash_attention(q, k, v, causal=True, q_offset=off))
    ref = jflash(jq, jk, jv, causal=True, q_offset=off, block_q=64, block_k=128, interpret=True)
    np.testing.assert_allclose(out, f32(ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(out, f32(attention_ref(jq, jk, jv, causal=True, q_offset=off)),
                               atol=2e-4, rtol=2e-4)


def test_interpreted_pallas_kernel_gives_nan_past_a_ragged_key_tail():
    """A reference fact, pinned: interpret mode fills the padded tail of the
    last key block with NaN, and the kernel body multiplies the masked
    p = 0 by those V rows, so every query row that visits that block comes
    out NaN.  The port never reads past seq_k (its kernel stages zeros)."""
    (jq, jk, jv), (q, k, v) = inputs(7, 1, 100, 100, 1, 1, 32)
    ref = f32(jflash(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True))
    rows_nan = np.isnan(ref).any(axis=(2, 3, 4))[0]
    assert rows_nan[64:].all() and not rows_nan[:64].any()
    out = f32(flash_attention(q, k, v, causal=True))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:, :64], ref[:, :64], atol=2e-4, rtol=2e-4)


def test_plain_takes_the_pallas_body_arithmetic():
    """Masked scores take the finite -1e30, and P.V is taken in float32 from
    an unrounded P: bf16 inputs give the float32 result of the same
    bf16-valued inputs, rounded once at the end."""
    _, (q, k, v) = inputs(4, 1, 48, 48, 1, 2, 16, "bfloat16")
    qf = q.permute(0, 2, 3, 1, 4).reshape(2, 48, 16)
    kf, vf = k.permute(0, 2, 1, 3).reshape(1, 48, 16), v.permute(0, 2, 1, 3).reshape(1, 48, 16)
    lo = flash_attention_ref(qf, kf, vf, groups=2, causal=True)
    hi = flash_attention_ref(qf.float(), kf.float(), vf.float(), groups=2, causal=True)
    assert lo.dtype == torch.bfloat16
    assert torch.equal(lo, hi.to(torch.bfloat16))
    assert torch.isfinite(hi).all()


def test_cpu_tensors_take_the_plain_version_uncounted():
    KERNEL_LAUNCHES["flash_attention"] = 0
    _, (q, k, v) = inputs(5, 1, 16, 16, 1, 2, 16)
    flash_attention(q, k, v)
    assert KERNEL_LAUNCHES == {"flash_attention": 0}


def test_negative_q_offset_is_refused():
    _, (q, k, v) = inputs(6, 1, 8, 8, 1, 1, 16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)


def test_kernel_wrapper_refuses_cpu_tensors():
    # the CUDA entry point never falls back to the plain version
    q = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.flash_attention_call(q, q[:1], q[:1], groups=2, causal=True)


def test_library_is_keyed_by_the_source(monkeypatch, tmp_path):
    a = fk.LIBRARY.path()
    assert a.name.startswith("libflash_attention_") and a.parent == _build.BUILD_DIR
    src = tmp_path / "flash_attention.cu"
    src.write_bytes(fk.LIBRARY.source.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(fk.LIBRARY, "source", src)
    assert fk.LIBRARY.path() != a


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_all_starts_one_nvcc_per_source(monkeypatch, tmp_path):
    # a stand-in compiler that records its start and writes the -o file
    log = tmp_path / "starts"
    nvcc = _fake_nvcc(tmp_path, (
        f'echo start >> {log}\nsleep 0.2\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo built > "$out"\n'
    ))
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    other = tmp_path / "b.cu"
    other.write_text("// any source: only its hash is read\n")
    libs = [_build.CudaLibrary(n, src, lambda lib: None, error_fn="e")
            for n, src in (("a", fk.LIBRARY.source), ("b", other))]
    for lib in libs:
        lib.build_dir = tmp_path / "build"
    paths = _build.build_all(libs)
    assert [p.name.split("_")[0] for p in paths] == ["liba", "libb"]
    assert all(p.read_text() == "built\n" for p in paths)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(p.name for p in paths)
    assert _build.build_all(libs) == paths  # built: nothing starts again
    assert log.read_text().count("start") == 2


def test_build_all_reports_every_failure(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no such intrinsic' >&2\nexit 3\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    lib = _build.CudaLibrary("fa", fk.LIBRARY.source, lambda lib: None, error_fn="e")
    lib.build_dir = tmp_path / "build"
    with pytest.raises(RuntimeError, match=r"nvcc failed to build flash_attention.cu \(exit 3\)"
                                           r":\nerror: no such intrinsic"):
        _build.build_all([lib])
    assert list((tmp_path / "build").iterdir()) == []
