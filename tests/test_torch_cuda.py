"""The Hopper kernels on the card, against their plain PyTorch versions.

Every case needs a CUDA card and ``nvcc``; each is marked ``cuda`` and skips
with a reason where there is none.  This file imports no JAX, so it runs
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import codec  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grib_pack as gp  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.grib_pack import kernel as gk  # noqa: E402
from repro_torch.kernels.grib_pack.ref import field_stats, pack_ref, unpack_ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sr  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill, train_loss  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

NBITS_ALL = (1, 8, 16, 24, 31)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
    before = default_device()
    set_default_device("cuda")
    yield torch.device("cuda")
    set_default_device(before)


def temperature_fields(rng, f, h, w):
    return (rng.standard_normal((f, h, w)) * 40 + 250).astype(np.float32)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# (3, 16, 128) takes the 16-byte vector path; 37*45 and 3 are not multiples
# of 4 and take the scalar one
@pytest.mark.parametrize("shape", [(3, 16, 128), (2, 37, 45), (1, 1, 3)])
@pytest.mark.parametrize("nbits", NBITS_ALL)
def test_kernels_equal_plain_version(cuda, shape, nbits):
    x = torch.from_numpy(temperature_fields(np.random.default_rng(nbits), *shape)).to(cuda)
    gp.reset_kernel_launches()
    codes, ref, scale = gp.grib_pack(x, nbits=nbits)
    out = gp.grib_unpack(codes, ref, scale)
    torch.cuda.synchronize()
    assert gp.KERNEL_LAUNCHES == {"grib_pack": 1, "grib_unpack": 1}
    _, _, inv = field_stats(x, nbits)
    assert torch.equal(codes, pack_ref(x, ref, inv, nbits))
    assert np.array_equal(bits(out), bits(unpack_ref(codes, ref, scale)))


def test_unaligned_view_takes_the_scalar_path(cuda):
    # a view one float into its storage is not 16-byte aligned
    x = torch.from_numpy(temperature_fields(np.random.default_rng(3), 1, 1, 65)).to(cuda)
    x = x.view(-1)[1:].view(1, 4, 16)
    ref, _, inv = field_stats(x, 16)
    assert torch.equal(gk.grib_pack_call(x, ref, inv, nbits=16), pack_ref(x, ref, inv, 16))


def test_stats_on_card_bit_equal_to_cpu(cuda):
    x = temperature_fields(np.random.default_rng(9), 4, 16, 128)
    for nbits in range(1, 32):
        on_cpu = field_stats(torch.from_numpy(x), nbits)
        on_card = field_stats(torch.from_numpy(x).to(cuda), nbits)
        for a, b in zip(on_cpu, on_card):
            assert np.array_equal(bits(a), bits(b)), nbits


def test_31_bit_saturation_on_card(cuda):
    x = torch.tensor([[[0.0, 1.0, 0.5, 1.0]]], device=cuda)
    codes, _, _ = gp.grib_pack(x, nbits=31)
    assert codes.cpu().tolist() == [[[0, 2**31 - 1, 2**30, 2**31 - 1]]]


def test_kernels_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 4, 8), device=cuda)
    r = torch.zeros(2, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        gk.grib_pack_call(x.double(), r, r, nbits=8)
    with pytest.raises(ValueError, match="scalars"):
        gk.grib_pack_call(x, r[:1], r, nbits=8)
    with pytest.raises(ValueError, match="contiguous"):
        gk.grib_unpack_call(x.to(torch.int32).transpose(1, 2), r, r)


@pytest.mark.parametrize("nbits", NBITS_ALL)
def test_card_payloads_equal_cpu_payloads(cuda, nbits):
    x = temperature_fields(np.random.default_rng(60 + nbits), 3, 37, 64)
    gp.reset_kernel_launches()
    codec.reset_kernel_launches()
    on_card = codec.encode_fields(torch.from_numpy(x).to(cuda), nbits=nbits)
    decoded = codec.decode_payloads(on_card)
    assert codec.kernel_launches() == {"pack": 1, "unpack": 1}
    assert gp.KERNEL_LAUNCHES == {"grib_pack": 1, "grib_unpack": 1}
    assert on_card == codec.encode_fields(x, nbits=nbits, device="cpu")
    for a, b in zip(decoded, codec.decode_payloads(on_card, device="cpu")):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


# ---------------------------------------------------------------------------
# flash attention (tolerances of tests/test_kernels.py:21-22)
# ---------------------------------------------------------------------------

def attn_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=2e-4, rtol=2e-4)


def attn_inputs(cuda, seed, bk, groups, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda, dtype)
            for s in ((bk * groups, sq, d), (bk, sk, d), (bk, sk, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fk.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,off", [(64, 64, 0), (100, 100, 0), (77, 200, 123)])
def test_flash_kernel_equals_plain_version(cuda, dtype, d, causal, sq, sk, off):
    q, k, v = attn_inputs(cuda, d + sq, 2, 3, sq, sk, d, dtype)
    out = fk.flash_attention_call(q, k, v, groups=3, causal=causal, q_offset=off)
    ref = flash_attention_ref(q, k, v, groups=3, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), **attn_tol(dtype))


# the bf16 wgmma instance: chip_smoke.py's served prompt lengths at seed 0,
# drawn as its phase 5 draws them (all ragged against 128), Sq < 128, Sq = 1,
# Sq < Sk with q_offset, and bidirectional; against the plain version at
# 2e-2, and against the plain version that rounds P to bf16 as the instance
# does at one bf16 ulp
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
SERVED_LENGTHS = chip_smoke.served_lengths(np.random.default_rng(0))
WGMMA_SHAPES = [*((n, n, True, 0) for n in SERVED_LENGTHS),
                (77, 77, True, 0), (1, 300, True, 299), (200, 645, True, 445), (333, 333, False, 0)]


@pytest.mark.parametrize("d", fk.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("groups", [1, 3, 8])
@pytest.mark.parametrize("sq,sk,causal,off", WGMMA_SHAPES)
def test_wgmma_instance_equals_plain_version(cuda, d, groups, sq, sk, causal, off):
    assert fk.instance_for(torch.bfloat16, d) == "wgmma"
    q, k, v = attn_inputs(cuda, d + groups + sq, 2, groups, sq, sk, d, torch.bfloat16)
    out = fk.flash_attention_call(q, k, v, groups=groups, causal=causal, q_offset=off)
    ref = flash_attention_ref(q, k, v, groups=groups, causal=causal, q_offset=off)
    rounded = flash_attention_ref(q, k, v, groups=groups, causal=causal, q_offset=off, round_p=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), rounded.float(), atol=2e-3, rtol=8e-3)


def test_wgmma_instance_reads_unaligned_views(cuda):
    # TMA needs 16-byte aligned addresses: a view 1 element into its storage is copied
    q, k, v = attn_inputs(cuda, 5, 1, 2, 64, 64, 64, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qv = buf[1:].view(q.shape)
    qv.copy_(q)
    assert qv.data_ptr() % 16 != 0
    out = fk.flash_attention_call(qv, k, v, groups=2, causal=True)
    torch.testing.assert_close(out, fk.flash_attention_call(q, k, v, groups=2, causal=True))


def test_flash_wrapper_counts_each_launch(cuda):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 40, 2, 4, 64), dtype=np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 64), dtype=np.float32)).to(cuda)
    fa.reset_kernel_launches()
    out = fa.flash_attention(q, k, k, causal=True)
    assert fa.KERNEL_LAUNCHES == {"flash_attention": 1}
    assert fa.INSTANCE_LAUNCHES == {"wgmma": 0, "cuda_cores": 1}
    cpu = fa.flash_attention(q.cpu(), k.cpu(), k.cpu(), causal=True)
    assert fa.KERNEL_LAUNCHES == {"flash_attention": 1}
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-4, rtol=2e-4)
    fa.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16(), causal=True)
    assert fa.KERNEL_LAUNCHES == {"flash_attention": 2}
    assert fa.INSTANCE_LAUNCHES == {"wgmma": 1, "cuda_cores": 1}
    fa.reset_kernel_launches()
    assert fa.INSTANCE_LAUNCHES == {"wgmma": 0, "cuda_cores": 0}


@pytest.mark.parametrize("d", fk.WGMMA_HEAD_DIMS)
def test_cuda_core_instance_refuses_the_wgmma_head_dims_in_bf16(cuda, d):
    # bf16 at these head dims has one route, the wgmma instance: the CUDA-core
    # entry point is not built for them and answers cudaErrorInvalidValue (1)
    q = torch.zeros((2, 64, d), device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    lib = fk.LIBRARY.load()
    err = lib.flash_attention_fwd_launch(1, d, q.data_ptr(), q.data_ptr(), q.data_ptr(),
                                         out.data_ptr(), 2, 64, 64, 1, 1, 0, 1.0, None)
    assert err == 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        fk.LIBRARY.check(err, "flash_attention")
    qf, of = q.float(), out.float()  # float32 at the same head dim is this instance's
    assert lib.flash_attention_fwd_launch(0, d, qf.data_ptr(), qf.data_ptr(), qf.data_ptr(),
                                          of.data_ptr(), 2, 64, 64, 1, 1, 0, 1.0, None) == 0
    torch.cuda.synchronize()


def test_a_second_build_of_the_source_launches_beside_the_first(cuda, tmp_path):
    # each loaded library asks for its own kernels' shared memory above 48 KB:
    # a second build of the source, loaded after the package's, launches too
    header = (fk.LIBRARY.source.parent / "../../csrc/hopper.cuh").resolve()
    src = fk.LIBRARY.source.read_text().replace('#include "../../csrc/hopper.cuh"',
                                                f'#include "{header}"')
    path = tmp_path / "flash_attention_copy.cu"
    path.write_text(src + "\n// a second build\n")
    copy = _build.CudaLibrary("flash_attention_copy", path, fk._bind,
                              error_fn="flash_attention_error_string")
    copy.build_dir = tmp_path
    q, k, v = attn_inputs(cuda, 11, 2, 8, 300, 300, 128, torch.bfloat16)
    want = fk.flash_attention_call(q, k, v, groups=8, causal=True)
    out = torch.empty_like(q)
    err = copy.load().flash_attention_wgmma_launch(
        128, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 16, 300, 300, 8, 1, 0,
        128 ** -0.5, torch.cuda.current_stream().cuda_stream)
    copy.check(err, "flash_attention")
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_flash_kernel_refuses_bad_inputs(cuda):
    q = torch.zeros((4, 8, 64), device=cuda)
    k = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fk.flash_attention_call(q.half(), k.half(), k.half(), groups=2, causal=True)
    with pytest.raises(ValueError, match="head dim 48"):
        fk.flash_attention_call(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                k[..., :48].contiguous(), groups=2, causal=True)
    with pytest.raises(ValueError, match="query rows"):
        fk.flash_attention_call(q, k, k, groups=3, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_attention_call(q.transpose(0, 1).contiguous().transpose(0, 1), k, k,
                                groups=2, causal=True)
    with pytest.raises(ValueError, match="k is torch.bfloat16"):
        fk.flash_attention_call(q, k.bfloat16(), k, groups=2, causal=True)


def test_serving_on_the_card_launches_the_kernel_per_layer_and_matches_the_cpu(cuda):
    """reduced(qwen2.5-3b) in float32 with attn_impl="pallas": one kernel
    launch per layer per prefill, and the card's tokens equal the CPU's."""
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), attn_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32) for n in (5, 70, 33)]
    gens = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(params.to(dev), cfg, max_batch=2, cache_len=96)
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=6))
        fa.reset_kernel_launches()
        gens[dev] = [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)]
        launches = fa.KERNEL_LAUNCHES["flash_attention"]
        assert launches == (cfg.n_layers * len(prompts) if dev == "cuda" else 0)
        assert fa.INSTANCE_LAUNCHES == {"wgmma": 0, "cuda_cores": launches}  # float32
    assert gens["cuda"] == gens["cpu"]


# the shapes chip_smoke.py's phase 8 serves that phases 4-5 do not: zamba2's
# head dim 112 at 32 heads, groups 1, at its longest and shortest prompts,
# whisper's encoder (bidirectional, 1500 frames) and cross attention
# (bidirectional, Sq != Sk), 24 batch-heads; all on the wgmma instance
@pytest.mark.parametrize("bk,groups,sq,sk,d,causal", [(32, 1, 1291, 1291, 112, True),
                                                       (32, 1, 123, 123, 112, True),
                                                       (24, 1, 1500, 1500, 64, False),
                                                       (24, 1, 391, 1500, 64, False),
                                                       (24, 1, 309, 1500, 64, False)])
def test_flash_kernel_at_the_families_served_shapes(cuda, bk, groups, sq, sk, d, causal):
    assert fk.instance_for(torch.bfloat16, d) == "wgmma"
    q, k, v = attn_inputs(cuda, sq + sk, bk, groups, sq, sk, d, torch.bfloat16)
    out = fk.flash_attention_call(q, k, v, groups=groups, causal=causal)
    ref = flash_attention_ref(q, k, v, groups=groups, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **attn_tol(torch.bfloat16))


@pytest.mark.parametrize("arch,sites", [("mamba2-370m", 0), ("zamba2-7b", 1),
                                        ("granite-moe-3b-a800m", 2), ("whisper-tiny", 6)])
def test_every_family_decodes_on_the_card_as_on_the_cpu(cuda, arch, sites):
    """Reduced configs in float32 with attn_impl="pallas": one kernel launch
    per attention site per prefill (whisper: encoder, self and cross), and
    the card's greedy tokens and logits equal the CPU's."""
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    # 2 x 16 tokens: one moe dispatch group of the reduced group_size 32
    prompt = rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32)
    frames = rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = params.to(dev)
        kw = {"enc_frames": torch.from_numpy(frames).to(dev)} if cfg.is_encoder_decoder else {}
        cache = init_cache(cfg, 2, 24, enc_len=40 if kw else 0, device=dev)
        fa.reset_kernel_launches()
        with torch.inference_mode():
            logits, cache = prefill(p, cfg, torch.from_numpy(prompt).to(dev), cache, **kw)
            out, toks = [logits.cpu()], []
            for _ in range(3):
                toks.append(logits[:, : cfg.vocab].argmax(-1).cpu())
                logits, cache = decode_step(p, cfg, toks[-1][:, None].to(dev), cache)
                out.append(logits.cpu())
        assert fa.KERNEL_LAUNCHES["flash_attention"] == (sites if dev == "cuda" else 0)
        runs[dev] = (out, toks)
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(runs["cuda"][1], runs["cpu"][1]))


# ---------------------------------------------------------------------------
# SSD scan (tolerances of tests/test_kernels.py:96)
# ---------------------------------------------------------------------------

def ssd_tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 else dict(atol=2e-4, rtol=2e-4)


def ssd_inputs(cuda, seed, b, s, h, p, n, dtype):
    """Flattened kernel operands: x (b*h, s, p), dt (b*h, s), A and D (b*h, 1), B and C (b, s, n)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b * h, s, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b * h, s)))).astype(np.float32)
    a = np.repeat(-np.exp(rng.standard_normal((1, h))), b, axis=0).reshape(b * h, 1)
    bb, cc = (rng.standard_normal((b, s, n), dtype=np.float32) for _ in range(2))
    d = rng.standard_normal((b * h, 1)).astype(np.float32)
    f32 = [torch.from_numpy(v.astype(np.float32)).to(cuda) for v in (dt, a, d)]
    x, bb, cc = (torch.from_numpy(v).to(cuda, dtype) for v in (x, bb, cc))
    return x, f32[0], f32[1], bb, cc, f32[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", sk.HEAD_DIMS)
@pytest.mark.parametrize("n", sk.STATE_DIMS)
@pytest.mark.parametrize("s,chunk", [(128, 64), (96, 96), (64, 16)])
def test_ssd_kernel_equals_plain_version(cuda, dtype, p, n, s, chunk):
    args = ssd_inputs(cuda, p + n + s, 2, s, 3, p, n, dtype)
    out = sk.ssd_scan_call(*args, heads=3, chunk=chunk)
    ref = ssd_scan_ref(*args, heads=3, chunk=chunk)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), ref.float(), **ssd_tol(dtype))


def test_ssd_wrapper_counts_each_launch(cuda):
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 0, 2, 64, 3, 16, 8, torch.float32)
    x4 = x.reshape(2, 3, 64, 16).permute(0, 2, 1, 3)
    dt4 = dt.reshape(2, 3, 64).permute(0, 2, 1)
    ss.reset_kernel_launches()
    out = ss.ssd_scan(x4, dt4, a[:3, 0], bb, cc, d[:3, 0], chunk=32)
    assert ss.KERNEL_LAUNCHES == {"ssd_scan": 1}
    assert ss.INSTANCE_LAUNCHES == {"split": 0, "fwd": 1}
    cpu = ss.ssd_scan(*(t.cpu() for t in (x4, dt4, a[:3, 0], bb, cc, d[:3, 0])), chunk=32)
    assert ss.KERNEL_LAUNCHES == {"ssd_scan": 1}
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-4, rtol=2e-4)
    # bf16 at head dim 64, state 128: the split instance, one call of three launches
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 0, 2, 64, 3, 64, 128, torch.bfloat16)
    x4 = x.reshape(2, 3, 64, 64).permute(0, 2, 1, 3)
    ss.ssd_scan(x4, dt4, a[:3, 0], bb, cc, d[:3, 0], chunk=32)
    ss.ssd_scan(x4.float(), dt4, a[:3, 0], bb.float(), cc.float(), d[:3, 0], chunk=32)
    assert ss.KERNEL_LAUNCHES == {"ssd_scan": 3}
    assert ss.INSTANCE_LAUNCHES == {"split": 1, "fwd": 2}
    ss.reset_kernel_launches()
    assert ss.INSTANCE_LAUNCHES == {"split": 0, "fwd": 0} and ss.KERNEL_LAUNCHES == {"ssd_scan": 0}


# The split instance (bf16, head dim 64, state 64 or 128): every chunk length
# the wrapper takes, ragged ones (20, 96) included: a 64-row tile that runs
# past the end of a chunk is masked.  Its float32 scratch is held against the
# plain functions of its launches at float32 sums of a chunk of products in
# another order; its output, where it rounds to bf16, at one bf16 ulp.
SPLIT_TOL = dict(atol=2e-3, rtol=8e-3)
SCRATCH_TOL = dict(atol=1e-4, rtol=1e-5)
SPLIT_SHAPES = [(128, 64), (96, 96), (64, 16), (192, 96), (100, 20), (512, 256)]


@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
@pytest.mark.parametrize("s,chunk", SPLIT_SHAPES)
def test_split_launches_equal_their_plain_versions(cuda, n, s, chunk):
    x, dt, a, bb, cc, d = ssd_inputs(cuda, n + s + chunk, 2, s, 3, 64, n, torch.bfloat16)
    scan = sk.SplitScan(x, dt, a, bb, cc, d, heads=3, chunk=chunk)
    scan.chunk_state()
    cum, states = sr.ssd_chunk_state_ref(x, dt, a, bb, heads=3, chunk=chunk, split_bf16=True)
    scan.state_pass()
    scan.chunk_scan()
    torch.cuda.synchronize()
    assert states.shape == scan.states.shape and scan.h.shape == (6, s // chunk, n, 64)
    torch.testing.assert_close(scan.cum, cum, **SCRATCH_TOL)
    torch.testing.assert_close(scan.states, states, **SCRATCH_TOL)
    torch.testing.assert_close(scan.h, sr.ssd_state_pass_ref(scan.states, scan.cum, chunk=chunk),
                               **SCRATCH_TOL)
    want = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=3, chunk=chunk,
                                 split_bf16=True)
    torch.testing.assert_close(scan.out.float(), want.float(), **SPLIT_TOL)


@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
@pytest.mark.parametrize("s,chunk", SPLIT_SHAPES)
def test_split_instance_equals_plain_version(cuda, n, s, chunk):
    args = ssd_inputs(cuda, n + s + chunk + 1, 2, s, 3, 64, n, torch.bfloat16)
    assert sk.instance_for(torch.bfloat16, 64, n) == "split"
    out = sk.ssd_scan_call(*args, heads=3, chunk=chunk)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    rounded = ssd_scan_ref(*args, heads=3, chunk=chunk, split_bf16=True)
    torch.testing.assert_close(out.float(), rounded.float(), **SPLIT_TOL)
    torch.testing.assert_close(out.float(), ssd_scan_ref(*args, heads=3, chunk=chunk).float(),
                               **ssd_tol(torch.bfloat16))


def test_split_instance_reads_unaligned_views(cuda):
    # cp.async reads 16-byte pieces: a view 1 element into its storage is copied
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 4, 1, 128, 2, 64, 64, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0
    out = sk.ssd_scan_call(xv, dt, a, bb, cc, d, heads=2, chunk=64)
    assert torch.equal(out, sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=2, chunk=64))


@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
def test_fwd_instance_refuses_the_split_shapes_in_bf16(cuda, n):
    # bf16 at head dim 64 and these state sizes has one route, the split
    # instance: the CUDA-core entry point answers cudaErrorInvalidValue (1)
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 5, 1, 64, 2, 64, n, torch.bfloat16)
    out = torch.empty_like(x)
    lib = sk.LIBRARY.load()

    def fwd(dtype, x, bb, cc, out):
        return lib.ssd_scan_fwd_launch(dtype, 64, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                                       bb.data_ptr(), cc.data_ptr(), d.data_ptr(), out.data_ptr(),
                                       2, 64, n, 32, 2, None)
    err = fwd(1, x, bb, cc, out)
    assert err == 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        sk.LIBRARY.check(err, "ssd_scan")
    assert fwd(0, x.float(), bb.float(), cc.float(), out.float()) == 0  # float32 is this instance's
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="split instance takes bf16"):
        sk.SplitScan(x.float(), dt, a, bb.float(), cc.float(), d, heads=2, chunk=32)


def test_ssd_kernel_refuses_bad_inputs(cuda):
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 1, 1, 64, 2, 24, 8, torch.float32)
    with pytest.raises(ValueError, match="head dim 24"):
        sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=2, chunk=32)
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 1, 1, 64, 2, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="state size 32"):
        sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=2, chunk=32)
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 1, 1, 64, 2, 16, 8, torch.float32)
    with pytest.raises(ValueError, match="multiple of chunk 48"):
        sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=2, chunk=48)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sk.ssd_scan_call(x.half(), dt, a, bb.half(), cc.half(), d, heads=2, chunk=32)
    with pytest.raises(ValueError, match="B is torch.bfloat16"):
        sk.ssd_scan_call(x, dt, a, bb.bfloat16(), cc, d, heads=2, chunk=32)
    with pytest.raises(ValueError, match="do not hold 1 heads"):
        sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=1, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_scan_call(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, bb, cc, d,
                         heads=2, chunk=32)


def test_kernels_refuse_gradients_on_the_card(cuda):
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 2, 1, 64, 2, 16, 8, torch.float32)
    x4 = x.reshape(1, 2, 64, 16).permute(0, 2, 1, 3).requires_grad_(True)
    out = ss.ssd_scan(x4, dt.reshape(1, 2, 64).permute(0, 2, 1), a[:, 0], bb, cc, d[:, 0], chunk=32)
    with pytest.raises(NotImplementedError, match="no VJP"):
        out.sum().backward()
    q, k, _ = attn_inputs(cuda, 3, 2, 2, 16, 16, 64, torch.float32)
    q = q.reshape(1, 2, 2, 16, 64).permute(0, 3, 1, 2, 4).requires_grad_(True)
    k = k.reshape(1, 2, 16, 64).permute(0, 2, 1, 3)
    with pytest.raises(NotImplementedError, match="no VJP"):
        fa.flash_attention(q, k, k, causal=True).sum().backward()


def test_ssm_scoring_on_the_card_launches_the_kernel_per_layer_and_matches_the_cpu(cuda):
    """reduced(mamba2-370m) in float32 with attn_impl="pallas": one kernel
    launch per layer per pass, and the card's loss equals the CPU's."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")), attn_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 65)).astype(np.int32)
    losses = {}
    for dev in ("cpu", "cuda"):
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "targets": torch.from_numpy(toks[:, 1:]).to(dev)}
        ss.reset_kernel_launches()
        with torch.no_grad():
            losses[dev] = float(train_loss(params.to(dev), cfg, batch)[0])
        assert ss.KERNEL_LAUNCHES["ssd_scan"] == (cfg.n_layers if dev == "cuda" else 0)
    assert losses["cuda"] == pytest.approx(losses["cpu"], abs=1e-4)
