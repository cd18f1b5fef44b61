"""The port's SSD scan and Mamba2 mixer on the CPU, against the JAX package.

The plain version of the hand-written kernel (``ssd_scan_ref``, on the
kernel's flattened shapes) is held against the reference's Pallas kernel in
interpret mode, its O(S) recurrence and its ``ssd_chunked``, at the shapes
and tolerances of ``tests/test_kernels.py:74-112``; so are the plain versions
of the split instance's three launches, composed.  The port's own
``ssd_chunked`` and ``causal_conv1d`` are held against the reference's at
1e-5 in float32, and ``mamba_mixer`` at 1e-4.  Inputs come from a numpy seed.
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as jsequential  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunk_scan_ref, ssd_chunk_state_ref, ssd_scan_ref, ssd_sequential_ref, ssd_state_pass_ref,
)
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
# the whole mixer chains five projections, three convolutions, the scan and
# a norm, each summing in float32 in another order than XLA: 1e-4 (measured
# 1.6e-5 on outputs of magnitude 1)
MIXER = dict(atol=1e-4, rtol=1e-4)
SHAPES = [  # tests/test_kernels.py:76-83: (b, s, h, p, n, chunk)
    (1, 64, 1, 8, 4, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 256, 2, 64, 16, 64),
    (2, 96, 2, 16, 8, 32),
]


def kernel_tol(dtype):  # tests/test_kernels.py:96
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def ssd_inputs(seed, b, s, h, p, n, d_zero=False):
    """x, dt (softplus), A (negative), B, C, D as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    D = np.zeros(h, np.float32) if d_zero else np.ones(h, np.float32)
    return x, dt, A, B, C, D


def to_jax(dtype, x, dt, A, B, C, D):
    """x, B and C in ``dtype``; dt, A and D in float32 (as the model gives them)."""
    jd = jnp.dtype(dtype)
    return (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B).astype(jd), jnp.asarray(C).astype(jd), jnp.asarray(D))


def to_torch(dtype, x, dt, A, B, C, D):
    td = getattr(torch, dtype)
    return (torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(B).to(td), torch.from_numpy(C).to(td), torch.from_numpy(D))


def flat(x, dt, A, B, C, D):
    """The kernel's operands, as ops.ssd_scan flattens them."""
    b, s, h, p = x.shape
    return (x.permute(0, 2, 1, 3).reshape(b * h, s, p), dt.permute(0, 2, 1).reshape(b * h, s),
            A[None].expand(b, h).reshape(b * h, 1), B, C, D[None].expand(b, h).reshape(b * h, 1))


def unflat(y, b, h):
    bh, s, p = y.shape
    return y.reshape(b, h, s, p).permute(0, 2, 1, 3)


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# the kernel's plain version against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_version_matches_interpreted_pallas_kernel(b, s, h, p, n, chunk, dtype):
    inputs = ssd_inputs(p + n + s, b, s, h, p, n)
    want = jssd_scan(*to_jax(dtype, *inputs), chunk=chunk, interpret=True)
    got = unflat(ssd_scan_ref(*flat(*to_torch(dtype, *inputs)), heads=h, chunk=chunk), b, h)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **kernel_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_version_matches_sequential_and_chunked_references(b, s, h, p, n, chunk, dtype):
    inputs = ssd_inputs(p + n + s + 1, b, s, h, p, n)
    j = to_jax(dtype, *inputs)
    got = as_np(unflat(ssd_scan_ref(*flat(*to_torch(dtype, *inputs)), heads=h, chunk=chunk), b, h))
    np.testing.assert_allclose(got, as_np(jsequential(*j)), **kernel_tol(dtype))
    np.testing.assert_allclose(got, as_np(jssm.ssd_chunked(*j, chunk=chunk)), **kernel_tol(dtype))


# The full-size heads at chunk 256: zamba2-7b's state 64 and mamba2-370m's
# 128, head dim 64.  Every decay there is exp(cum_i - cum_j) of prefixes that
# reach several hundred, so two float32 evaluations differ by far more than
# at the small shapes: measured max |plain - interpreted Pallas| 2.2e-3
# (state 64) and 1.2e-3 (128) on outputs up to 160 in float32, 0.031 and
# 0.125 (one bf16 ulp) in bf16.
FULL_CHUNK_TOL = {"float32": dict(atol=5e-3, rtol=2e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def exact_scan(x, dt, A, B, C, D):
    """The O(S) recurrence in float64 on the given inputs."""
    x, dt, A, B, C, D = (np.asarray(v, np.float64) for v in (x, dt, A, B, C, D))
    state = np.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        state = np.exp(dt[:, t] * A)[..., None, None] * state + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, C[:, t]))
    return np.stack(ys, 1) + x * D[None, None, :, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 128])
def test_plain_version_matches_interpreted_pallas_kernel_at_full_chunk(n, dtype):
    b, s, h, p = 1, 512, 2, 64
    inputs = ssd_inputs(p + n + s, b, s, h, p, n)
    want = jssd_scan(*to_jax(dtype, *inputs), chunk=256, interpret=True)
    got = unflat(ssd_scan_ref(*flat(*to_torch(dtype, *inputs)), heads=h, chunk=256), b, h)
    np.testing.assert_allclose(as_np(got), as_np(want), **FULL_CHUNK_TOL[dtype])


@pytest.mark.parametrize("n", [64, 128])
def test_plain_version_error_is_of_the_pallas_kernels_order_at_full_chunk(n):
    """Against a float64 recurrence, the plain version (float64 prefix sums,
    each rounded once to float32) errs by no more than 2.5x the reference's
    own Pallas kernel (float32 prefix sums): both carry the rounding of
    float32 prefixes near several hundred.  Measured 1.4e-3 against 7.5e-4
    (state 64) and 9.1e-4 against 5.0e-4 (128)."""
    b, s, h, p = 1, 512, 2, 64
    inputs = ssd_inputs(p + n + s, b, s, h, p, n)
    exact = exact_scan(*inputs)
    pallas = as_np(jssd_scan(*to_jax("float32", *inputs), chunk=256, interpret=True))
    plain = as_np(unflat(ssd_scan_ref(*flat(*to_torch("float32", *inputs)), heads=h, chunk=256), b, h))
    assert np.abs(plain - exact).max() <= 2.5 * np.abs(pallas - exact).max()


def test_plain_version_carries_state_across_chunks():
    """tests/test_kernels.py:100-112: one long chunk against many small ones."""
    inputs = to_torch("float32", *ssd_inputs(7, 1, 128, 2, 8, 4, d_zero=True))
    one = ssd_scan_ref(*flat(*inputs), heads=2, chunk=128)
    many = ssd_scan_ref(*flat(*inputs), heads=2, chunk=16)
    np.testing.assert_allclose(one.numpy(), many.numpy(), atol=1e-4, rtol=1e-4)


def test_plain_version_masks_the_exponent_before_exp():
    """A long chunk with strong decay: cum differences above the diagonal are
    large and positive, and exp of them would overflow; nothing is NaN."""
    x, dt, A, B, C, D = ssd_inputs(8, 1, 256, 2, 16, 8)
    A = np.full_like(A, -30.0)
    got = ssd_scan_ref(*flat(*to_torch("float32", x, dt, A, B, C, D)), heads=2, chunk=256)
    assert torch.isfinite(got).all()
    want = jsequential(*to_jax("float32", x, dt, A, B, C, D))
    np.testing.assert_allclose(as_np(unflat(got, 1, 2)), as_np(want), atol=2e-4, rtol=2e-4)


def test_sequential_ref_matches_reference():
    inputs = ssd_inputs(9, 2, 48, 3, 8, 4)
    np.testing.assert_allclose(ssd_sequential_ref(*to_torch("float32", *inputs)).numpy(),
                               as_np(jsequential(*to_jax("float32", *inputs))), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_reference_wrapper(dtype):
    """ops.ssd_scan keeps the reference's transposes and broadcasts."""
    b, s, h, p, n, chunk = SHAPES[1]
    inputs = ssd_inputs(10, b, s, h, p, n)
    ss.reset_kernel_launches()
    got = ss.ssd_scan(*to_torch(dtype, *inputs), chunk=chunk)
    assert ss.KERNEL_LAUNCHES == {"ssd_scan": 0}  # the plain version is not counted
    want = jssd_scan(*to_jax(dtype, *inputs), chunk=chunk, interpret=True)
    assert got.shape == (b, s, h, p)
    np.testing.assert_allclose(as_np(got), as_np(want), **kernel_tol(dtype))


def test_kernel_has_no_backward_on_the_cpu():
    """As jax.grad through the Pallas kernel raises, backward() through the
    port's kernel (here its plain version) raises; a forward under grad mode works."""
    x, dt, A, B, C, D = to_torch("float32", *ssd_inputs(11, 1, 32, 2, 8, 4))
    x.requires_grad_(True)
    y = ss.ssd_scan(x, dt, A, B, C, D, chunk=16)
    assert y.requires_grad and torch.isfinite(y).all()
    with pytest.raises(NotImplementedError, match="no VJP"):
        y.sum().backward()
    with pytest.raises(AssertionError):  # the reference refuses too
        jax.grad(lambda v: jssd_scan(v, *to_jax("float32", *ssd_inputs(11, 1, 32, 2, 8, 4))[1:],
                                     chunk=16, interpret=True).sum())(jnp.asarray(x.detach().numpy()))


def test_kernel_call_takes_cuda_tensors_only():
    inputs = flat(*to_torch("float32", *ssd_inputs(12, 1, 32, 2, 8, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan_call(*inputs, heads=2, chunk=16)


# ---------------------------------------------------------------------------
# the split instance's three launches, plainly
# ---------------------------------------------------------------------------

# the full-size heads at chunk 256, and chunks that end inside a 64-row tile
SPLIT_SHAPES = SHAPES + [(1, 512, 2, 64, 64, 256), (1, 512, 2, 64, 128, 256),
                         (2, 192, 2, 64, 64, 96), (1, 100, 2, 64, 128, 20)]


def three_launches(x, dt, A, B, C, D, *, heads, chunk, split_bf16=False):
    """ssd_chunk_state_ref, ssd_state_pass_ref and ssd_chunk_scan_ref in turn."""
    cum, states = ssd_chunk_state_ref(x, dt, A, B, heads=heads, chunk=chunk, split_bf16=split_bf16)
    h = ssd_state_pass_ref(states, cum, chunk=chunk)
    return ssd_chunk_scan_ref(x, dt, cum, h, C, B, D, heads=heads, chunk=chunk,
                              split_bf16=split_bf16)


@pytest.mark.parametrize("split_bf16", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SPLIT_SHAPES)
def test_three_launches_compose_to_the_plain_version(b, s, h, p, n, chunk, split_bf16):
    """Only the state recurrence is serial: the chunk states, the pass over
    them and the chunk outputs give what the one-pass plain version gives."""
    args = flat(*to_torch("float32", *ssd_inputs(p + n + s + 2, b, s, h, p, n)))
    got = three_launches(*args, heads=h, chunk=chunk, split_bf16=split_bf16)
    want = ssd_scan_ref(*args, heads=h, chunk=chunk, split_bf16=split_bf16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 128])
def test_three_launches_match_interpreted_pallas_kernel_at_full_chunk(n, dtype):
    b, s, h, p = 1, 512, 2, 64
    inputs = ssd_inputs(p + n + s, b, s, h, p, n)
    want = jssd_scan(*to_jax(dtype, *inputs), chunk=256, interpret=True)
    got = unflat(three_launches(*flat(*to_torch(dtype, *inputs)), heads=h, chunk=256), b, h)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **FULL_CHUNK_TOL[dtype])


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("n", [64, 128])
def test_split_bf16_operands_keep_float32_precision(monkeypatch, n, terms):
    """Feeding the scores, w*x and h as bf16 terms moves the float32 scan by
    about 2^-(9 terms - 1) of its largest output.  The split instance's three
    terms (split_bf16=True) moved it by nothing measurable (0 at both state
    sizes): the sum of the terms is the float32 value.  Two terms (hi + lo)
    moved it by 4.7e-4 and 6.8e-4 on outputs up to 142 and 158, about 2^-18 of
    them, and that was too much for chip_smoke.py's loss gate.  Asserted: three
    terms below 2^-22 of the largest output, two above zero and below 2^-16."""
    b, s, h, p = 1, 512, 2, 64
    args = flat(*to_torch("float32", *ssd_inputs(p + n + s, b, s, h, p, n)))
    exact = ssd_scan_ref(*args, heads=h, chunk=256)
    rounding = ref.split_bf16_round
    monkeypatch.setattr(ref, "split_bf16_round", lambda v: rounding(v, terms))
    split = ssd_scan_ref(*args, heads=h, chunk=256, split_bf16=True)
    gap, top = float((split - exact).abs().max()), float(exact.abs().max())
    if terms == ref.SPLIT_TERMS:
        assert gap <= 2**-22 * top
    else:
        assert 0 < gap <= 2**-16 * top


def test_state_pass_starts_from_zero_and_decays_by_the_chunk_total():
    states = torch.from_numpy(np.random.default_rng(17).standard_normal((2, 2, 3, 4), dtype=np.float32))
    cum = torch.tensor([[-1.0, -2.0, -0.5, -1.5, 0.0, -3.0], [0.0] * 6])
    h = ssd_state_pass_ref(states, cum, chunk=2)
    assert h.shape == (2, 3, 3, 4) and not h[:, 0].any()
    torch.testing.assert_close(h[:, 1], states[:, 0])
    decay = torch.exp(torch.tensor([-1.5, 0.0]))[:, None, None]
    torch.testing.assert_close(h[:, 2], decay * states[:, 0] + states[:, 1])


@pytest.mark.parametrize("dtype,p,n,instance", [
    (torch.bfloat16, 64, 64, "split"), (torch.bfloat16, 64, 128, "split"),
    (torch.bfloat16, 64, 16, "fwd"), (torch.bfloat16, 16, 128, "fwd"), (torch.bfloat16, 8, 4, "fwd"),
    (torch.float32, 64, 128, "fwd"), (torch.float32, 64, 64, "fwd"), (torch.float32, 32, 16, "fwd"),
])
def test_instance_is_chosen_from_dtype_head_dim_and_state_size(dtype, p, n, instance):
    assert sk.instance_for(dtype, p, n) == instance
    assert instance in sk.INSTANCES and ss.INSTANCE_LAUNCHES.keys() == set(sk.INSTANCES)


def test_fwd_instance_dispatches_every_head_dim_the_wrapper_admits():
    # the C switch of ssd_scan_fwd's dispatch and HEAD_DIMS cannot drift apart
    source = sk.LIBRARY.source.read_text()
    start = source.index("cudaError_t dispatch(int p,")
    body = source[start:source.index("\n}\n", start)]
    assert tuple(int(d) for d in re.findall(r"case (\d+):", body)) == sk.HEAD_DIMS


def test_split_scan_takes_cuda_tensors_only():
    args = flat(*to_torch("bfloat16", *ssd_inputs(18, 1, 64, 2, 64, 64)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.SplitScan(*args, heads=2, chunk=32)


def test_build_keeps_what_ptxas_warns(monkeypatch, tmp_path):
    """A stand-in nvcc under a temporary CUDA_HOME warns on a build that
    succeeds; the warning stays on the library, and ptxas is asked for it."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "echo \"ptxas warning : Registers are spilled to local memory in function 'k', "
        "8 bytes spill stores, 8 bytes spill loads\" >&2\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo built > "$out"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))  # no nvcc on the PATH
    assert _build._nvcc() == str(nvcc)
    lib = _build.CudaLibrary("warned", sk.LIBRARY.source, lambda lib: None, error_fn="e")
    lib.build_dir = tmp_path / "build"
    assert lib.build_log == ""
    path = lib.build()
    assert path.read_text() == "built\n"
    assert "spilled to local memory" in lib.build_log
    flags = _build.NVCC_FLAGS
    assert flags[flags.index("-Xptxas") + 1] == "-warn-spills,-warn-lmem-usage"


def test_precision_tool_edits_match_the_source_once():
    # tools/ssd_scan_precision.py builds variants of the split instance by
    # textual edits; each must still find its one place in the source
    spec = importlib.util.spec_from_file_location(
        "ssd_scan_precision", Path(__file__).resolve().parents[1] / "tools" / "ssd_scan_precision.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = sk.LIBRARY.source.read_text()
    assert tool.VARIANTS["as shipped (three bf16 terms)"] == [] and len(tool.VARIANTS) > 1
    assert f"constexpr int TERMS = {ref.SPLIT_TERMS};" in source  # the plain version's count
    for name, edits in tool.VARIANTS.items():
        for old, new in edits:
            assert source.count(old) == 1 and old != new, name


def test_library_is_built_from_the_source_in_the_repo():
    lib = sk.LIBRARY
    assert lib.source.name == "ssd_scan.cu" and lib.source.exists()
    assert lib.path().parent == _build.BUILD_DIR and lib.path().name.startswith("libssd_scan_")
    assert "ssd_scan_kernel" in lib.source.read_text()  # names the TPU kernel it replaces


# ---------------------------------------------------------------------------
# models/ssm.py against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    b, s, h, p, n, chunk = 2, 64, 3, 8, 4, 16
    x, dt, A, B, C, D = ssd_inputs(13, b, s, h, p, n)
    h0 = np.random.default_rng(14).standard_normal((b, h, p, n), dtype=np.float32) if with_h0 else None
    jy, jst = jssm.ssd_chunked(*to_jax("float32", x, dt, A, B, C, D), chunk=chunk,
                               h0=None if h0 is None else jnp.asarray(h0), return_state=True)
    ty, tst = tssm.ssd_chunked(*to_torch("float32", x, dt, A, B, C, D), chunk=chunk,
                               h0=None if h0 is None else torch.from_numpy(h0), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **F32)
    y_only = tssm.ssd_chunked(*to_torch("float32", x, dt, A, B, C, D), chunk=chunk)
    assert torch.equal(y_only, tssm.ssd_chunked(*to_torch("float32", x, dt, A, B, C, D), chunk=chunk))
    with pytest.raises(ValueError, match="not divisible"):
        tssm.ssd_chunked(*to_torch("float32", x, dt, A, B, C, D), chunk=24)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 11, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    bias = rng.standard_normal(6, dtype=np.float32)
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # causal: output t never sees inputs after t
    x2 = x.copy()
    x2[:, 7:] = 0
    got2 = tssm.causal_conv1d(torch.from_numpy(x2), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_array_equal(got2[:, :7].numpy(), got[:, :7].numpy())


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_mamba_mixer_matches_reference(impl):
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")), attn_impl=impl)
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-370m")), attn_impl=impl)
    jp = jinit_params(jcfg, jax.random.PRNGKey(16))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(16).standard_normal((2, 64, cfg.d_model), dtype=np.float32)
    jbp = jax.tree.map(lambda a: a[0], jp["blocks"])
    want = jssm.mamba_mixer(jnp.asarray(x), jbp, jcfg)
    got = tssm.mamba_mixer(torch.from_numpy(x), tp["blocks"][0], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIXER)
