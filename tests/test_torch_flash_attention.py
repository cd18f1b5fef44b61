"""The port's flash attention on the CPU, against the JAX package.

The plain PyTorch version (what the Hopper kernel computes) is held against
the reference's oracle ``attention_ref`` and against its Pallas kernel run in
interpret mode, on the same inputs made from a numpy seed, at the shapes of
``tests/test_kernels.py`` (tolerances 2e-4 in float32 and 2e-2 in bfloat16,
as there).  The wrapper's dispatch, launch counter and build helper are
checked here too; the kernel itself runs in ``tests/test_torch_cuda.py``.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import _build, launches  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, flash_attention_ref_blocked  # noqa: E402

SHAPES = [  # b, sq, sk, kh, g, d (tests/test_kernels.py:28-34)
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 2, 3, 64),
    (1, 128, 384, 2, 2, 128),
    (2, 64, 64, 4, 1, 32),
]
# zamba2-7b's shared attention, which the wgmma instance takes in bf16: head
# dim 112, groups 1, whole blocks of 64 and 128 rows (the interpreted kernel
# gives NaN past a ragged key tail, pinned below)
D112_SHAPES = [  # b, sq, sk, kh, g, d
    (1, 64, 64, 2, 1, 112),
    (2, 128, 128, 1, 1, 112),
    (1, 128, 256, 2, 1, 112),
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
@pytest.mark.parametrize("b,sq,sk,kh,g,d", SHAPES + D112_SHAPES)
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


def flat(q, k, v):
    """The kernel's layout: (B*K*G, Sq, d) and (B*K, Sk, d), as ops.flash_attention flattens."""
    b, sq, kh, g, d = q.shape
    sk = k.shape[1]
    return (q.permute(0, 2, 3, 1, 4).reshape(b * kh * g, sq, d),
            k.permute(0, 2, 1, 3).reshape(b * kh, sk, d), v.permute(0, 2, 1, 3).reshape(b * kh, sk, d))


@pytest.mark.parametrize("b,sq,sk,kh,g,d", SHAPES + D112_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_round_p_plain_matches_pallas_kernel_interpreted(b, sq, sk, kh, g, d, causal):
    """The plain version with P rounded to bf16, as the wgmma instance rounds
    it, against the interpreted Pallas kernel in bf16.  Every length is under
    128 or a multiple of it (the NaN of a ragged key tail, pinned below)."""
    (jq, jk, jv), (q, k, v) = inputs(8, b, sq, sk, kh, g, d, "bfloat16")
    ref = jflash(jq, jk, jv, causal=causal, interpret=True)
    out = flash_attention_ref(*flat(q, k, v), groups=g, causal=causal, round_p=True)
    out = out.reshape(b, kh, g, sq, d).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(f32(out), f32(ref), **tol("bfloat16"))


def test_round_p_rounds_only_p_before_p_v():
    """round_p=False is the Pallas body as before; round_p=True takes P.V from
    P rounded to bf16, while l still sums the float32 P."""
    _, (q, k, v) = inputs(9, 1, 40, 40, 1, 2, 32, "bfloat16")
    qf, kf, vf = flat(q, k, v)
    s = torch.matmul(qf.float().reshape(1, 2, 40, 32), kf.float()[:, None].transpose(-1, -2))
    s = torch.where(torch.ones(40, 40, dtype=torch.bool).tril(), s / 32 ** 0.5, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    for round_p, pv in ((False, p), (True, p.bfloat16().float())):
        want = (torch.matmul(pv, vf.float()[:, None]) / l).reshape(2, 40, 32).bfloat16()
        got = flash_attention_ref(qf, kf, vf, groups=2, causal=True, round_p=round_p)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.equal(flash_attention_ref(qf, kf, vf, groups=2, causal=True),
                           flash_attention_ref(qf, kf, vf, groups=2, causal=True, round_p=True))


def test_instance_is_chosen_from_dtype_and_head_dim_alone():
    for d in fk.HEAD_DIMS:
        assert fk.instance_for(torch.float32, d) == "cuda_cores"
        assert fk.instance_for(torch.bfloat16, d) == ("wgmma" if d in (64, 96, 112, 128)
                                                      else "cuda_cores")
    assert fk.instance_for(torch.bfloat16, 224) == "wgmma"  # the published Zamba2's, wgmma alone
    assert fk.WGMMA_HEAD_DIMS == (64, 96, 112, 128, 224)


def _c_function(source: str, signature: str) -> str:
    """The body of the C function of the source that starts with ``signature``."""
    start = source.index(signature)
    body = source[source.index("{", start):]
    depth = 0
    for i, ch in enumerate(body):
        depth += {"{": 1, "}": -1}.get(ch, 0)
        if depth == 0:
            return body[:i + 1]
    raise AssertionError(f"no end to {signature}")


def test_c_entry_points_take_the_head_dims_the_routing_sends_them():
    # the Python routing (instance_for) and the C switch statements cannot
    # drift apart: the wgmma entry point takes WGMMA_HEAD_DIMS, the CUDA-core
    # one bf16 at the other head dims and float32 at every one
    source = fk.LIBRARY.source.read_text()
    wgmma = _c_function(source, "int flash_attention_wgmma_launch(")
    assert tuple(int(d) for d in re.findall(r"case (\d+):", wgmma)) == fk.WGMMA_HEAD_DIMS
    bf16 = _c_function(source, "cudaError_t dispatch_bf16(")
    f32_ = _c_function(source, "cudaError_t dispatch_f32(")
    assert tuple(int(d) for d in re.findall(r"FA_CASE\(__nv_bfloat16, (\d+)\)", bf16)) == tuple(
        d for d in fk.HEAD_DIMS if d not in fk.WGMMA_HEAD_DIMS)
    assert tuple(int(d) for d in re.findall(r"FA_CASE\(float, (\d+)\)", f32_)) == fk.HEAD_DIMS


def test_cpu_tensors_take_the_plain_version_uncounted():
    launches.reset()
    _, (q, k, v) = inputs(5, 1, 16, 16, 1, 2, 16)
    flash_attention(q, k, v)
    assert launches.snapshot() == {}  # by instance and head dim too


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
    source = fk.LIBRARY.source.read_bytes()
    headers = _build.local_headers(fk.LIBRARY.source)
    assert [h.name for h in headers] == ["hopper.cuh"]
    src = tmp_path / "flash_attention.cu"
    src.write_bytes(source + b"\n// edited\n")
    monkeypatch.setattr(fk.LIBRARY, "source", src)
    assert fk.LIBRARY.path() != a
    # and by the headers it includes: copies of the source and of
    # kernels/csrc/hopper.cuh, laid out as in the package, key as the
    # originals do until the header changes
    copy = tmp_path / "flash_attention" / "csrc" / "flash_attention.cu"
    copy.parent.mkdir(parents=True)
    copy.write_bytes(source)
    header = tmp_path / "csrc" / "hopper.cuh"
    header.parent.mkdir()
    header.write_bytes(headers[0].read_bytes())
    monkeypatch.setattr(fk.LIBRARY, "source", copy)
    assert fk.LIBRARY.path() == a
    header.write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    assert fk.LIBRARY.path() != a


def test_on_card_cases_cover_every_served_length():
    # tests/test_torch_cuda.py and chip_smoke.py phase 4 hold the wgmma
    # instance at phase 5's prompt lengths, drawn by chip_smoke.served_lengths
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lengths = smoke.served_lengths(np.random.default_rng(0))
    assert len(lengths) == smoke.SERVE_REQUESTS and all(n % 128 for n in lengths)
    cases = smoke.wgmma_cases(0)
    assert {(sq, sk, causal, off) for _, _, sq, sk, _, causal, off in cases} >= {
        (n, n, True, 0) for n in lengths}
    assert {c[4] for c in cases} == set(fk.WGMMA_HEAD_DIMS) and {c[1] for c in cases} == {1, 3, 8}
    assert all(fk.instance_for(torch.bfloat16, c[4]) == "wgmma" for c in cases)
    assert any(c[2] == 1 for c in cases) and any(1 < c[2] < 128 for c in cases)
    assert any(c[2] < c[3] and c[6] > 0 for c in cases) and any(not c[5] for c in cases)


@pytest.mark.parametrize("groups,sq,sk,causal,off,d,scale", [
    (1, 130, 130, True, 0, 64, None), (3, 40, 200, True, 160, 224, 112 ** -0.5),
    (2, 77, 77, False, 0, 112, None), (1, 1, 300, True, 299, 224, 112 ** -0.5)])
def test_blocked_plain_version_is_the_plain_version_rounded_in_the_kernels_order(groups, sq, sk, causal, off, d,
                                                                                 scale):
    # one block of every key rounds P at the row's max, as round_p=True does;
    # 64-key blocks round it at the running max, and stay within bf16 of plain
    gen = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for shape in ((2 * groups, sq, d), (2, sk, d), (2, sk, d)))
    kw = dict(groups=groups, causal=causal, q_offset=off, scale=scale)
    whole = flash_attention_ref_blocked(q, k, v, key_block=sk, **kw)
    torch.testing.assert_close(whole.float(), flash_attention_ref(q, k, v, round_p=True, **kw).float(),
                               atol=2e-3, rtol=8e-3)
    blocked = flash_attention_ref_blocked(q, k, v, key_block=64, **kw)
    assert blocked.dtype == torch.bfloat16 and blocked.shape == q.shape
    torch.testing.assert_close(blocked.float(), flash_attention_ref(q, k, v, **kw).float(), atol=2e-2, rtol=2e-2)


def test_chip_smoke_holds_the_kernel_order_up_to_one_flipped_rounding_of_p():
    # chip_smoke.held_in_kernel_order lets an element past ROUND_P_TOL by no more
    # than one bf16 ulp of its row's largest P_j |V_jc| / l, and catches a wrong scale
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((3, 150, 224), generator=gen).to(torch.bfloat16) for _ in range(3))
    kw = dict(groups=1, causal=True, scale=smoke.ZAMBA2_SCALE)
    exact = flash_attention_ref_blocked(q, k, v, key_block=fk.WGMMA_KEY_BLOCK[224], **kw)
    assert smoke.held_in_kernel_order(exact, q, k, v, **kw) == (0.0, 0)
    r, i, c = 1, 0, 7  # the first query attends to its own key alone: P = 1 carries the row
    limit = smoke.ROUND_P_TOL["atol"] + smoke.ROUND_P_TOL["rtol"] * abs(float(exact[r, i, c]))
    flip = 2.0 ** -7 * abs(float(v[r, 0, c]))
    for past, ok in ((0.5 * flip, True), (2 * flip, False)):
        out = exact.float().clone()
        out[r, i, c] += limit + past
        if ok:
            gap, n = smoke.held_in_kernel_order(out, q, k, v, **kw)
            assert n == 1 and gap == pytest.approx(limit + past, rel=1e-3)
        else:
            with pytest.raises(AssertionError, match="flipped rounding"):
                smoke.held_in_kernel_order(out, q, k, v, **kw)
    wrong = flash_attention_ref_blocked(q, k, v, key_block=64, groups=1, causal=True, scale=224 ** -0.5)
    with pytest.raises(AssertionError):
        smoke.held_in_kernel_order(wrong, q, k, v, **kw)


def test_ablation_tool_edits_match_the_source_once():
    # tools/flash_attention_ablation.py takes parts of the wgmma instance out
    # by textual edits; each must still find its one place in the source
    spec = importlib.util.spec_from_file_location(
        "flash_attention_ablation",
        Path(__file__).resolve().parents[1] / "tools" / "flash_attention_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = fk.LIBRARY.source.read_text()
    assert tool.ABLATIONS["as shipped"] == [] and len(tool.ABLATIONS) > 1
    for name, edits in tool.ABLATIONS.items():
        for old, new in edits:
            assert source.count(old) == 1 and old != new, name


def test_local_headers_follow_nested_includes_and_skip_toolkit_ones(tmp_path):
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "inc/a.cuh"\n#include "missing.h"\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text('#include "a.cuh"\n')
    assert _build.local_headers(tmp_path / "k.cu") == [(tmp_path / "inc" / "a.cuh").resolve(),
                                                       (tmp_path / "inc" / "b.cuh").resolve()]


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
