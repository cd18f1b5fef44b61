"""The port's SSD scan and Mamba2 mixer on the CPU, against the JAX package.

The plain version of the hand-written kernel (``ssd_scan_ref``, on the
kernel's flattened shapes) is held against the reference's Pallas kernel in
interpret mode, its O(S) recurrence and its ``ssd_chunked``, at the shapes
and tolerances of ``tests/test_kernels.py:74-112``; so are the plain versions
of the split instance's two launches, composed.  The port's own
``ssd_chunked`` and ``causal_conv1d`` (the convolution kernel's plain
version, ``kernels/causal_conv/ref.py``) are held against the reference's at
1e-5 in float32, and ``mamba_mixer`` at 1e-4 (its gradient under "naive"
too); the convolution kernel's wrapper is that plain version on the CPU, bit
for bit.  Inputs come from a numpy seed.
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
from repro_torch.kernels import _build, launches  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunk_scan_ref, ssd_chunk_state_pass_ref, ssd_chunk_state_ref, ssd_scan_ref, ssd_sequential_ref,
    ssd_state_pass_ref,
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
    launches.reset()
    got = ss.ssd_scan(*to_torch(dtype, *inputs), chunk=chunk)
    assert launches.snapshot() == {}  # the plain version is not counted
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
# the split instance's two launches, plainly
# ---------------------------------------------------------------------------

# the full-size heads at chunk 256, and chunks that end inside a 64-row tile
SPLIT_SHAPES = SHAPES + [(1, 512, 2, 64, 64, 256), (1, 512, 2, 64, 128, 256),
                         (2, 192, 2, 64, 64, 96), (1, 100, 2, 64, 128, 20)]


def two_launches(x, dt, A, B, C, D, *, heads, chunk, split_bf16=False):
    """ssd_chunk_state_pass_ref and ssd_chunk_scan_ref in turn."""
    cum, h = ssd_chunk_state_pass_ref(x, dt, A, B, heads=heads, chunk=chunk, split_bf16=split_bf16)
    return ssd_chunk_scan_ref(x, dt, cum, h, C, B, D, heads=heads, chunk=chunk,
                              split_bf16=split_bf16)


@pytest.mark.parametrize("split_bf16", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SPLIT_SHAPES)
def test_two_launches_compose_to_the_plain_version(b, s, h, p, n, chunk, split_bf16):
    """Only the state recurrence is serial: the chunk states with the pass
    over them, then the chunk outputs, give what the one-pass plain version
    gives."""
    args = flat(*to_torch("float32", *ssd_inputs(p + n + s + 2, b, s, h, p, n)))
    got = two_launches(*args, heads=h, chunk=chunk, split_bf16=split_bf16)
    want = ssd_scan_ref(*args, heads=h, chunk=chunk, split_bf16=split_bf16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [64, 128])
def test_two_launches_match_interpreted_pallas_kernel_at_full_chunk(n, dtype):
    b, s, h, p = 1, 512, 2, 64
    inputs = ssd_inputs(p + n + s, b, s, h, p, n)
    want = jssd_scan(*to_jax(dtype, *inputs), chunk=256, interpret=True)
    got = unflat(two_launches(*flat(*to_torch(dtype, *inputs)), heads=h, chunk=256), b, h)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_np(got), as_np(want), **FULL_CHUNK_TOL[dtype])


@pytest.mark.parametrize("split_bf16", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SPLIT_SHAPES + [(2, 64, 3, 64, 128, 64), (1, 20, 2, 64, 64, 20)])
def test_chunk_state_pass_is_the_chunk_states_then_the_pass(b, s, h, p, n, chunk, split_bf16):
    """The fused launch's plain function is its two parts composed, bit for
    bit; over a single chunk (S = Q) the state entering it is all zeros."""
    x, dt, A, B, _, _ = flat(*to_torch("float32", *ssd_inputs(p + n + s + 3, b, s, h, p, n)))
    cum, h_ = ssd_chunk_state_pass_ref(x, dt, A, B, heads=h, chunk=chunk, split_bf16=split_bf16)
    want_cum, states = ssd_chunk_state_ref(x, dt, A, B, heads=h, chunk=chunk, split_bf16=split_bf16)
    assert torch.equal(cum, want_cum)
    assert torch.equal(h_, ssd_state_pass_ref(states, want_cum, chunk=chunk))
    assert h_.shape == (b * h, s // min(chunk, s), n, p) and h_.dtype == torch.float32
    assert not h_[:, 0].any()
    if s == chunk:
        assert states.shape[1] == 0 and not h_.any()


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
    assert instance in sk.INSTANCES


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


# ---------------------------------------------------------------------------
# the layouts of x: the wrapper's (B, S, H, P), which the split instance reads
# where it lies, and the flat (B*H, S, P) of every other caller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_wrapper_returns_the_mixers_layout_equal_to_ssd_chunked(groups):
    b, s, h, p, n, chunk = 2, 128, 4, 16, 8, 32
    x, dt, A, B, C, D = to_torch("float32", *ssd_inputs(21 + groups, b, s, h, p, n))
    if groups > 1:  # (B, S, G, N): each group's B and C shared by its H/G heads
        rng = np.random.default_rng(groups)
        B, C = (torch.from_numpy(rng.standard_normal((b, s, groups, n), dtype=np.float32)) for _ in range(2))
    got = ss.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    assert got.shape == (b, s, h, p) and got.dtype == x.dtype
    torch.testing.assert_close(got, tssm.ssd_chunked(x, dt, A, B, C, D, chunk=chunk), **kernel_tol("float32"))


@pytest.mark.parametrize("dtype,p,n", [("float32", 16, 8), ("bfloat16", 64, 128)])
def test_wrapper_hands_x_on_as_it_lies(monkeypatch, dtype, p, n):
    # one path for every instance: the wrapper flattens dt, A and D, never x;
    # the kernel's call (or, here, the plain version) decides how x is read
    b, s, h, chunk = 2, 64, 3, 32
    x, dt, A, B, C, D = to_torch(dtype, *ssd_inputs(29, b, s, h, p, n))
    seen = []

    def plain(x_, *rest, **kw):
        seen.append(x_)
        return ssd_scan_ref(x_, *rest, **kw)
    monkeypatch.setattr(ss.ops, "ssd_scan_ref", plain)
    got = ss.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    assert len(seen) == 1 and seen[0] is x
    assert torch.equal(got, unflat(ssd_scan_ref(*flat(x, dt, A, B, C, D), heads=h, chunk=chunk), b, h))


@pytest.mark.parametrize("split_bf16", [False, True])
def test_plain_version_takes_the_mixers_layout(split_bf16):
    b, s, h, p, n, chunk = 2, 128, 3, 64, 64, 32
    x, dt, A, B, C, D = to_torch("bfloat16", *ssd_inputs(23, b, s, h, p, n))
    args = flat(x, dt, A, B, C, D)
    got = ssd_scan_ref(x, *args[1:], heads=h, chunk=chunk, split_bf16=split_bf16)
    want = ssd_scan_ref(*args, heads=h, chunk=chunk, split_bf16=split_bf16)
    assert got.shape == (b, s, h, p)
    assert torch.equal(got, unflat(want, b, h))


def kernel_args(layout, *, p=16, n=8, dtype="float32", b=1, s=64, h=2):
    """ssd_scan_call's operands on the CPU, contiguous: x flat (B*H, S, P) or
    in the mixer's (B, S, H, P); dt, A and D flat."""
    x, dt, A, B, C, D = to_torch(dtype, *ssd_inputs(19, b, s, h, p, n))
    xf, *rest = (t.contiguous() for t in flat(x, dt, A, B, C, D))
    return (xf if layout == "flat" else x, *rest)


@pytest.mark.parametrize("layout", ["flat", "bshp"])
@pytest.mark.parametrize("p,n,dtype,chunk", [(16, 8, "float32", 32), (8, 4, "float32", 64),
                                             (64, 64, "bfloat16", 32), (64, 128, "bfloat16", 128)])
def test_kernel_call_takes_either_layout_of_x(layout, p, n, dtype, chunk):
    args = kernel_args(layout, p=p, n=n, dtype=dtype)
    assert sk.heads_per_row(args[0]) == (2 if layout == "bshp" else 1)
    assert sk.check_shapes(*args, heads=2, chunk=chunk) == (2, 64, p, n, min(chunk, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan_call(*args, heads=2, chunk=chunk)
    if sk.instance_for(args[0].dtype, p, n) == "split":
        with pytest.raises(ValueError, match="CUDA tensors"):
            sk.SplitScan(*args, heads=2, chunk=chunk)


def _non_contiguous(t):
    return t.transpose(1, 2).contiguous().transpose(1, 2)


# what ssd_scan_call refuses in the flat layout it refuses in the mixer's:
# message -> (kernel_args' keywords, the change to its operands, heads, chunk)
KERNEL_REFUSALS = {
    "head dim 24": (dict(p=24), lambda a: a, 2, 32),
    "state size 32": (dict(n=32), lambda a: a, 2, 32),
    "multiple of chunk 48": ({}, lambda a: a, 2, 48),
    "float32 or bfloat16": ({}, lambda a: (a[0].half(), a[1], a[2], a[3].half(), a[4].half(), a[5]), 2, 32),
    "B is torch.bfloat16": ({}, lambda a: (*a[:3], a[3].bfloat16(), *a[4:]), 2, 32),
    "do not hold 1 heads": ({}, lambda a: a, 1, 32),
    "contiguous": ({}, lambda a: (_non_contiguous(a[0]), *a[1:]), 2, 32),
    "ssd_scan takes x": ({}, lambda a: (a[0], a[1][None], *a[2:]), 2, 32),  # dt of three dims
}


@pytest.mark.parametrize("layout", ["flat", "bshp"])
@pytest.mark.parametrize("refusal", list(KERNEL_REFUSALS))
def test_kernel_call_refuses_the_same_inputs_in_either_layout(layout, refusal):
    kw, change, heads, chunk = KERNEL_REFUSALS[refusal]
    args = change(kernel_args(layout, **kw))
    with pytest.raises(ValueError, match=refusal):
        sk.check_shapes(*args, heads=heads, chunk=chunk)


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


GATE_LAYERS = 3


def gated_pass(scan):
    """A reduced mamba2 (3 layers, chunk 32) scoring 2 x 4 chunks through the
    per-layer gate around ``scan``; the gate."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.ssd_scan import gate as sg
    from repro_torch.models import init_params, train_loss

    cfg = dataclasses.replace(reduced(get_config("mamba2-370m"), n_layers=GATE_LAYERS),
                              attn_impl="pallas")
    assert cfg.ssm.chunk == 32
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    held = SyntheticLM(cfg.vocab, 4 * cfg.ssm.chunk, 2, seed=1).batch_for_step(0)
    gate = sg.LayerGate(scan, sg.faulty_scans(sg.plain_split))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ss.ops, "ssd_scan", gate)
        loss, _ = train_loss(params, cfg, {k: torch.from_numpy(v) for k, v in held.items()})
    assert np.isfinite(float(loss))
    assert [rec["chunks"] for rec in gate.layers] == [4] * GATE_LAYERS
    return gate


def test_layer_gate_holds_the_plain_split_version_and_rejects_both_faulty_scans():
    """chip_smoke.py's scoring gate: each layer's scan against the plain
    version with split operands on that layer's inputs at SPLIT_TOL, each
    faulty scan on the same inputs outside it on every layer of more than one
    chunk (measured here: at least 107x the tolerance)."""
    from repro_torch.kernels.ssd_scan import gate as sg

    gate = gated_pass(sg.plain_split)
    gate.check()
    assert all(rec["scan"] == 0 and rec["max_abs_err"] == 0 for rec in gate.layers)
    ratio, layer, name = gate.margin()
    assert ratio > 10 and 0 <= layer < GATE_LAYERS and name in gate.faults


@pytest.mark.parametrize("fault", ["no inter-chunk state", "A of the next head"])
def test_layer_gate_fails_a_faulty_scan_in_the_kernels_place(fault):
    from repro_torch.kernels.ssd_scan import gate as sg

    gate = gated_pass(sg.faulty_scans(sg.plain_split)[fault])
    assert all(rec["scan"] > 1 for rec in gate.layers)
    with pytest.raises(AssertionError, match="the scan is"):
        gate.check()


def test_gate_excess_is_at_most_one_where_assert_close_passes():
    from repro_torch.kernels.ssd_scan.gate import SPLIT_TOL, excess

    want = torch.tensor([0.0, 1.0, -100.0, 3.0])
    inside = want + torch.tensor([2e-3, 2e-3 + 8e-3, -(2e-3 + 0.8), 0.0]) * 0.999
    outside = want + torch.tensor([0.0, 0.0, 2e-3 + 0.8, 0.0]) * 1.01
    torch.testing.assert_close(inside, want, **SPLIT_TOL)
    assert 0.99 < excess(inside, want) <= 1 and excess(want, want) == 0
    assert excess(outside, want) == pytest.approx(1.01, rel=1e-5)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(outside, want, **SPLIT_TOL)
    assert excess(torch.tensor([float("nan")]), torch.tensor([0.0])) == float("inf")


def test_library_is_keyed_by_its_extra_flags(tmp_path):
    # the SSD-scan library asks ptxas for -v; another flag set is another library
    plain = _build.CudaLibrary("keyed", sk.LIBRARY.source, lambda lib: None, error_fn="e")
    verbose = _build.CudaLibrary("keyed", sk.LIBRARY.source, lambda lib: None, error_fn="e",
                                 extra_flags=("-Xptxas", "-v"))
    assert plain.flags == _build.NVCC_FLAGS and verbose.flags[-2:] == ("-Xptxas", "-v")
    assert plain.path() != verbose.path()
    assert sk.LIBRARY.flags == verbose.flags


def test_chip_smoke_counts_the_convolutions_bytes_and_operations():
    """One mixer's three convolutions at the score cell's shape move 4.832 GB
    (every input, weight, bias and output byte once), so the byte bound holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    b, s, widths, k = chip_smoke.CONV_FULL
    cfg = get_config("mamba2-370m")
    assert (b, s, widths, k) == (256, 2048, (cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_state),
                                 cfg.ssm.d_conv)
    nbytes, ops = chip_smoke.conv_work(b, s, widths, k, 2)
    assert nbytes == 4_831_861_248
    assert ops == 12 * 256 * 2048 * (2048 + 2 * 128)
    assert nbytes / chip_smoke.HBM_RATE > ops / chip_smoke.F32_PEAK


def test_chip_smoke_counts_each_split_launchs_work():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    bh, s, p, n, q, bg = 256, 2048, 64, 128, 256, 8  # the full-width scoring shape
    work = chip_smoke.split_launch_work(bh, s, p, n, q, bg)
    assert set(work) == {"ssd_chunk_state", "ssd_chunk_scan"}
    (state_ops, state_peak), (pass_ops, pass_peak) = work["ssd_chunk_state"][1]
    (scan_ops, scan_peak), = work["ssd_chunk_scan"][1]
    # the scan's products split between the two launches
    assert state_ops + scan_ops == chip_smoke.ssd_ops(bh, s, p, n, q, bg)
    assert state_peak == scan_peak == chip_smoke.BF16_PEAK and pass_peak == chip_smoke.F32_PEAK
    assert pass_ops == 2 * n * p * bh * (s // q - 1)
    # ssd_chunk_state: x, B, dt, A in, cum and h out, about 142.6 MB; no chunk states
    assert work["ssd_chunk_state"][0] == 142_607_360
    # ssd_chunk_scan: x, dt, cum, h, B, C, D in and y out, about 214 MB
    assert work["ssd_chunk_scan"][0] == 213_910_528
    bound, by = chip_smoke.launch_bound(*work["ssd_chunk_state"])
    assert by == "bytes" and bound == pytest.approx(142_607_360 / chip_smoke.HBM_RATE * 1e3)
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12sp14ssd_chunk_scanILi64EEEv14CUtensorMap_st' "
           "for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_12sp14ssd_chunk_scanILi64EEEv14CUtensorMap_st\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12sp15ssd_chunk_stateILi128EEEv14CUtensorMap_st' "
           "for 'sm_90a'\n"
           "ptxas info    : Used 168 registers, used 4 barriers\n")
    assert chip_smoke.ptxas_lines(log, "ssd_chunk_scan") == {
        "_ZN12_GLOBAL__N_12sp14ssd_chunk_scanILi64EEEv14CUtensorMap_st":
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; Used 168 registers, used 16 barriers"}
    assert chip_smoke.ptxas_lines(log, "ssd_chunk_state") == {
        "_ZN12_GLOBAL__N_12sp15ssd_chunk_stateILi128EEEv14CUtensorMap_st": "Used 168 registers, used 4 barriers"}


def test_ablation_tool_edits_match_the_source_once():
    # tools/ssd_scan_ablation.py takes parts of ssd_chunk_scan out by textual
    # edits; each must still find its one place in the source
    spec = importlib.util.spec_from_file_location(
        "ssd_scan_ablation", Path(__file__).resolve().parents[1] / "tools" / "ssd_scan_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = sk.LIBRARY.source.read_text()
    assert tool.ABLATIONS["as shipped"] == [] and set(tool.EXACT) <= set(tool.ABLATIONS)
    for name, edits in tool.ABLATIONS.items():
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
    """The plain version, which models.ssm.causal_conv1d is, against the reference's."""
    assert tssm.causal_conv1d is cc.ref.causal_conv1d
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,c,k", [(2, 11, 16, 4), (1, 1, 8, 4), (3, 2, 24, 4), (2, 3, 8, 3),
                                     (2, 40, 64, 2)])
def test_conv_kernel_wrapper_is_the_plain_version_on_the_cpu(dtype, b, s, c, k):
    """A CPU tensor goes to the plain version itself, sequences shorter than
    the window included: the same bits, and no launch counted."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((b, s, c), dtype=np.float32)).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal((k, c), dtype=np.float32))  # cast to x's type by both
    bias = torch.from_numpy(rng.standard_normal(c, dtype=np.float32))
    launches.reset()
    got = cc.causal_conv1d(x, w, bias)
    assert launches.snapshot() == {}
    assert got.dtype == x.dtype and got.shape == (b, s, c)
    assert torch.equal(got, cc.ref.causal_conv1d(x, w, bias))


def test_conv_kernel_has_no_backward_on_the_cpu():
    """As K4's wrapper, the convolution's wrapper refuses a gradient (here
    through its plain version); a forward under grad mode works."""
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((2, 9, 16), dtype=np.float32)).requires_grad_(True)
    w, bias = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for shape in ((4, 16), 16))
    y = cc.causal_conv1d(x, w, bias)
    assert y.requires_grad and torch.equal(y, cc.ref.causal_conv1d(x, w, bias))
    with pytest.raises(NotImplementedError, match="no VJP"):
        y.sum().backward()


def test_mamba_mixer_trains_through_the_plain_conv():
    """Under "naive" the mixer keeps the plain convolution, so the gradient
    of its output reaches the convolutions' weights and biases, and equals
    the reference's."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")), attn_impl="naive")
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-370m")), attn_impl="naive")
    jp = jinit_params(jcfg, jax.random.PRNGKey(16))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(16).standard_normal((2, 64, cfg.d_model), dtype=np.float32)
    jbp = jax.tree.map(lambda a: a[0], jp["blocks"])
    want = jax.grad(lambda p: jssm.mamba_mixer(jnp.asarray(x), p, jcfg).sum())(jbp)
    names = ("conv_x", "conv_x_b", "conv_B", "conv_B_b", "conv_C", "conv_C_b")
    params = {k: v.detach().clone().requires_grad_(k in names) for k, v in tp["blocks"][0].tree().items()}
    launches.reset()
    tssm.mamba_mixer(torch.from_numpy(x), params, cfg).sum().backward()
    assert launches.snapshot() == {}
    for name in names:
        assert params[name].grad.abs().max() > 1.0
        np.testing.assert_allclose(params[name].grad.numpy(), np.asarray(want[name]), **MIXER)


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
