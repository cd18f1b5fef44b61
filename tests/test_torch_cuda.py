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
from repro_torch.kernels import _build, launches  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grib_pack as gp  # noqa: E402
from repro_torch.kernels.causal_conv import kernel as ck  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.grib_pack import kernel as gk  # noqa: E402
from repro_torch.kernels.grib_pack.ref import field_stats, pack_ref, unpack_ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as sr  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill, train_loss  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
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
    launches.reset()
    codes, ref, scale = gp.grib_pack(x, nbits=nbits)
    out = gp.grib_unpack(codes, ref, scale)
    torch.cuda.synchronize()
    assert launches.snapshot() == {"grib_pack": 1, "grib_unpack": 1}
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
    launches.reset()
    codec.reset_kernel_launches()
    on_card = codec.encode_fields(torch.from_numpy(x).to(cuda), nbits=nbits)
    decoded = codec.decode_payloads(on_card)
    assert codec.kernel_launches() == {"pack": 1, "unpack": 1}
    assert launches.snapshot() == {"grib_pack": 1, "grib_unpack": 1}
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


# the published Zamba2's shared attention: head dim 224 at its scoring cell's
# 4096 tokens (a few of its 16 x 32 heads), ragged and bidirectional lengths,
# with its softmax scale (224 / 2)^-0.5 and the default 1/sqrt(224)
@pytest.mark.parametrize("sq,sk,causal,off", [(4096, 4096, True, 0), (4096, 4096, False, 0),
                                               (4000, 4000, True, 0), (1000, 4000, True, 3000),
                                               (130, 130, False, 0)])
@pytest.mark.parametrize("scale", [None, 112 ** -0.5])
def test_wgmma_instance_at_head_dim_224(cuda, sq, sk, causal, off, scale):
    q, k, v = attn_inputs(cuda, sq + sk + off, 3, 1, sq, sk, 224, torch.bfloat16)
    out = fk.flash_attention_call(q, k, v, groups=1, causal=causal, q_offset=off, scale=scale)
    rounded = flash_attention_ref(q, k, v, groups=1, causal=causal, q_offset=off, round_p=True, scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rounded.float(), atol=2e-3, rtol=8e-3)
    del rounded
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, groups=1, causal=causal, q_offset=off,
                                                                scale=scale).float(), atol=2e-2, rtol=2e-2)


def test_flash_wrapper_counts_launches_by_head_dim_and_takes_a_scale(cuda):
    q = torch.randn((1, 300, 4, 1, 224), device=cuda).bfloat16()
    k = torch.randn((1, 300, 4, 224), device=cuda).bfloat16()
    launches.reset()
    out = fa.flash_attention(q, k, k, causal=True, scale=112 ** -0.5)
    fa.flash_attention(q[..., :112].contiguous(), k[..., :112].contiguous(), k[..., :112].contiguous())
    assert launches.by("flash_attention", "head_dim") == {224: 1, 112: 1}
    assert launches.by("flash_attention", "instance") == {"wgmma": 2}
    cpu = fa.flash_attention(q.cpu().float(), k.cpu().float(), k.cpu().float(), causal=True, scale=112 ** -0.5)
    torch.testing.assert_close(out.float().cpu(), cpu, atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="positive finite scale"):
        fk.flash_attention_call(q[0].permute(1, 0, 2, 3).reshape(4, 300, 224).contiguous(),
                                k[0].permute(1, 0, 2).contiguous(), k[0].permute(1, 0, 2).contiguous(),
                                groups=1, causal=True, scale=-1.0)
    with pytest.raises(ValueError, match="head dim 224"):  # float32 at 224: no instance
        fk.flash_attention_call(torch.zeros((2, 8, 224), device=cuda), torch.zeros((2, 8, 224), device=cuda),
                                torch.zeros((2, 8, 224), device=cuda), groups=1, causal=True)
    launches.reset()
    assert launches.by("flash_attention", "head_dim") == {}


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
    launches.reset()
    out = fa.flash_attention(q, k, k, causal=True)
    assert launches.snapshot()["flash_attention"] == 1
    assert launches.by("flash_attention", "instance") == {"cuda_cores": 1}
    cpu = fa.flash_attention(q.cpu(), k.cpu(), k.cpu(), causal=True)
    assert launches.snapshot()["flash_attention"] == 1
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-4, rtol=2e-4)
    fa.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16(), causal=True)
    assert launches.snapshot()["flash_attention"] == 2
    assert launches.by("flash_attention", "instance") == {"wgmma": 1, "cuda_cores": 1}
    launches.reset()
    assert launches.snapshot() == {}


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
    qf, of = q.float(), out.float()  # float32 at the same head dim is this instance's, up to 128
    assert lib.flash_attention_fwd_launch(0, d, qf.data_ptr(), qf.data_ptr(), qf.data_ptr(),
                                          of.data_ptr(), 2, 64, 64, 1, 1, 0, 1.0, None) == (
        0 if d in fk.HEAD_DIMS else 1)
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
        launches.reset()
        gens[dev] = [r.generated for r in sorted(eng.run(), key=lambda r: r.rid)]
        n = launches.snapshot()["flash_attention"]
        assert n == (cfg.n_layers * len(prompts) if dev == "cuda" else 0)
        assert launches.by("flash_attention", "instance") == ({"cuda_cores": n} if n else {})  # float32
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
        launches.reset()
        with torch.inference_mode():
            logits, cache = prefill(p, cfg, torch.from_numpy(prompt).to(dev), cache, **kw)
            out, toks = [logits.cpu()], []
            for _ in range(3):
                toks.append(logits[:, : cfg.vocab].argmax(-1).cpu())
                logits, cache = decode_step(p, cfg, toks[-1][:, None].to(dev), cache)
                out.append(logits.cpu())
        assert launches.snapshot()["flash_attention"] == (sites if dev == "cuda" else 0)
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
    launches.reset()
    out = ss.ssd_scan(x4, dt4, a[:3, 0], bb, cc, d[:3, 0], chunk=32)
    assert launches.snapshot()["ssd_scan"] == 1
    assert launches.by("ssd_scan", "instance") == {"fwd": 1}
    assert launches.by("ssd_scan", "layout") == {"flat": 1}
    cpu = ss.ssd_scan(*(t.cpu() for t in (x4, dt4, a[:3, 0], bb, cc, d[:3, 0])), chunk=32)
    assert launches.snapshot()["ssd_scan"] == 1
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-4, rtol=2e-4)
    # bf16 at head dim 64, state 128: the split instance, one call of two launches
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 0, 2, 64, 3, 64, 128, torch.bfloat16)
    x4 = x.reshape(2, 3, 64, 64).permute(0, 2, 1, 3)
    ss.ssd_scan(x4, dt4, a[:3, 0], bb, cc, d[:3, 0], chunk=32)
    ss.ssd_scan(x4.float(), dt4, a[:3, 0], bb.float(), cc.float(), d[:3, 0], chunk=32)
    assert launches.snapshot()["ssd_scan"] == 3
    assert launches.by("ssd_scan", "instance") == {"split": 1, "fwd": 2}
    assert launches.by("ssd_scan", "layout") == {"bshp": 1, "flat": 2}
    launches.reset()
    assert launches.snapshot() == {}


# The split instance (bf16, head dim 64, state 64 or 128): every chunk length
# the wrapper takes, ragged ones (20, 96) included: a 64-row tile that runs
# past the end of a chunk is masked.  Its float32 scratch is held against the
# plain functions of its launches at float32 sums of a chunk of products in
# another order; its output, where it rounds to bf16, at one bf16 ulp.
SPLIT_TOL = dict(atol=2e-3, rtol=8e-3)
SCRATCH_TOL = dict(atol=1e-4, rtol=1e-5)
SPLIT_SHAPES = [(128, 64), (96, 96), (64, 16), (192, 96), (100, 20), (512, 256)]


def check_split_launches(scan, args, heads, chunk):
    """The first launch run with its check output: its cumsum and chunk states
    against ssd_chunk_state_ref, its h against ssd_state_pass_ref of its own
    chunk states; then the main path's launch (no check output), whose h must
    be the same bits, and the second launch's output against its plain
    function."""
    x, dt, a, bb, cc, d = args
    nc = x.shape[1] // chunk
    states = torch.empty((x.shape[0], nc - 1, bb.shape[-1], 64), dtype=torch.float32, device=x.device)
    scan.chunk_state(states)
    cum, want_states = sr.ssd_chunk_state_ref(x, dt, a, bb, heads=heads, chunk=chunk, split_bf16=True)
    checked = scan.h.clone()
    scan.chunk_state()
    scan.chunk_scan()
    torch.cuda.synchronize()
    assert scan.h.shape == (x.shape[0], nc, bb.shape[-1], 64)
    torch.testing.assert_close(scan.cum, cum, **SCRATCH_TOL)
    torch.testing.assert_close(states, want_states, **SCRATCH_TOL)
    torch.testing.assert_close(checked, sr.ssd_state_pass_ref(states, scan.cum, chunk=chunk), **SCRATCH_TOL)
    assert torch.equal(scan.h, checked), "the check output moved h"
    want = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=heads, chunk=chunk,
                                 split_bf16=True)
    torch.testing.assert_close(scan.out.float(), want.float(), **SPLIT_TOL)


@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
@pytest.mark.parametrize("s,chunk", SPLIT_SHAPES)
def test_split_launches_equal_their_plain_versions(cuda, n, s, chunk):
    args = ssd_inputs(cuda, n + s + chunk, 2, s, 3, 64, n, torch.bfloat16)
    check_split_launches(sk.SplitScan(*args, heads=3, chunk=chunk), args, 3, chunk)


# ssd_chunk_state chains the state pass across its blocks: 8 x 64 chunks x 16
# head groups are 8192 blocks, many more than the card holds at once, so
# blocks wait for predecessors that ran in an earlier round
@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
def test_chunk_state_chains_more_blocks_than_the_card_holds(cuda, n):
    args = ssd_inputs(cuda, n + 7, 8, 1024, 32, 64, n, torch.bfloat16)
    scan = sk.SplitScan(*args, heads=32, chunk=16)
    check_split_launches(scan, args, 32, 16)
    torch.testing.assert_close(scan.out.float(), ssd_scan_ref(*args, heads=32, chunk=16,
                                                              split_bf16=True).float(), **SPLIT_TOL)


def test_chunk_state_gives_the_same_bits_back_to_back(cuda):
    # each launch zeroes its ticket and flags on its stream before it runs
    args = ssd_inputs(cuda, 11, 2, 2048, 32, 64, 128, torch.bfloat16)
    scan = sk.SplitScan(*args, heads=32, chunk=256)
    runs = []
    for _ in range(20):
        scan.chunk_state()
        runs.append((scan.cum.clone(), scan.h.clone()))
    torch.cuda.synchronize()
    for cum, h in runs[1:]:
        assert torch.equal(cum, runs[0][0]) and torch.equal(h, runs[0][1])
    cum, h = sr.ssd_chunk_state_pass_ref(*args[:4], heads=32, chunk=256, split_bf16=True)
    torch.testing.assert_close(runs[0][0], cum, **SCRATCH_TOL)
    torch.testing.assert_close(runs[0][1], h, **SCRATCH_TOL)


# A block of ssd_chunk_state reads each x stage by ldmatrix (the generic
# proxy) before the next TMA load (the async proxy) refills it.  Without a
# proxy fence between the two, at N 64 and a grid this large (64 x 32 heads
# x 8 chunks, three blocks an SM) a few chunk states of most launches came
# out wrong, in whole warps' 16-row slices of p; every launch's chunk
# states here are held against the plain function and must be the same bits
@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
def test_chunk_state_reads_each_x_stage_before_it_is_refilled(cuda, n):
    args = ssd_inputs(cuda, n + 15, 64, 2048, 32, 64, n, torch.bfloat16)
    scan = sk.SplitScan(*args, heads=32, chunk=256)
    _, want = sr.ssd_chunk_state_ref(*args[:4], heads=32, chunk=256, split_bf16=True)
    states = torch.empty_like(want)
    runs = []
    for _ in range(6):
        scan.chunk_state(states)
        runs.append(states.clone())
    torch.cuda.synchronize()
    for got in runs:
        torch.testing.assert_close(got, want, **SCRATCH_TOL)
        assert torch.equal(got, runs[0])


def test_two_split_scans_on_two_streams_at_once(cuda):
    # each instance has its own ticket and flags: the two launches' blocks
    # share the card and wait only for their own predecessors
    cases = [ssd_inputs(cuda, 12 + i, 4, 2048, 32, 64, n, torch.bfloat16) for i, n in enumerate((128, 64))]
    scans = [sk.SplitScan(*args, heads=32, chunk=256) for args in cases]
    streams = [torch.cuda.Stream() for _ in scans]
    for stream, scan in zip(streams, scans):
        stream.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        for stream, scan in zip(streams, scans):
            with torch.cuda.stream(stream):
                scan.run()
    torch.cuda.synchronize()
    for args, scan in zip(cases, scans):
        torch.testing.assert_close(scan.out.float(), ssd_scan_ref(*args, heads=32, chunk=256,
                                                                  split_bf16=True).float(), **SPLIT_TOL)
        cum, h = sr.ssd_chunk_state_pass_ref(*args[:4], heads=32, chunk=256, split_bf16=True)
        torch.testing.assert_close(scan.cum, cum, **SCRATCH_TOL)
        torch.testing.assert_close(scan.h, h, **SCRATCH_TOL)


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


# ssd_chunk_scan makes each C_i . B_j^T once for a group of 8 heads of a
# batch entry: head counts the group does not divide (3 and 9), mamba2-370m's
# 32 heads at S 512, and chunks of 512 rows, whose G tiles take two windows
# with a group of 2 heads.  Each against
# its plain function, the whole instance against the plain version, and a
# second launch of ssd_chunk_scan bit-equal to the first.
GROUP_SHAPES = [(512, 256, 9, 128), (512, 256, 9, 64), (512, 256, 3, 128), (512, 256, 32, 128),
                (1024, 512, 3, 128), (1024, 512, 3, 64)]


@pytest.mark.parametrize("s,chunk,heads,n", GROUP_SHAPES)
def test_chunk_scan_shares_c_b_across_head_groups(cuda, s, chunk, heads, n):
    assert sk.LIBRARY.load().ssd_chunk_scan_group(chunk) == (8 if chunk <= 256 else 2)
    args = ssd_inputs(cuda, s + chunk + heads + n, 2, s, heads, 64, n, torch.bfloat16)
    x, dt, a, bb, cc, d = args
    scan = sk.SplitScan(*args, heads=heads, chunk=chunk)
    out = scan.run().clone()
    torch.cuda.synchronize()
    want = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=heads, chunk=chunk,
                                 split_bf16=True)
    torch.testing.assert_close(out.float(), want.float(), **SPLIT_TOL)
    torch.testing.assert_close(out.float(), ssd_scan_ref(*args, heads=heads, chunk=chunk).float(),
                               **ssd_tol(torch.bfloat16))
    scan.chunk_scan()
    torch.cuda.synchronize()
    assert torch.equal(scan.out, out), "two launches of ssd_chunk_scan differ"


# grouped B and C as the published Zamba2 has them: 112 heads in 2 groups of
# 56, each group's B and C (N 64) one row of the kernel's (B*G, S, N), at the
# scoring cell's 4096 tokens (2 of its 16 rows); each group's heads against
# the plain version with its own group's B and C, and against the other's
@pytest.mark.parametrize("rows,s", [(2, 4096), (3, 512)])
def test_grouped_scan_reads_each_groups_b_and_c(cuda, rows, s):
    h, g, n = 112, 2, 64
    x, dt, a, _, _, d = ssd_inputs(cuda, rows + s, rows, s, h, 64, n, torch.bfloat16)
    rng = np.random.default_rng(s)
    bb, cc = (torch.from_numpy(rng.standard_normal((rows, s, g, n), dtype=np.float32)).to(cuda).bfloat16()
              for _ in range(2))
    xs = x.reshape(rows, h, s, 64).permute(0, 2, 1, 3)  # the model's (B, S, H, P)
    dts = dt.reshape(rows, h, s).permute(0, 2, 1)
    launches.reset()
    y = ss.ssd_scan(xs, dts, a[:h, 0], bb, cc, d[:h, 0], chunk=256)
    torch.cuda.synchronize()
    assert launches.by("ssd_scan", "instance") == {"split": 1}
    hg = h // g
    for r in range(rows):
        for grp in range(g):
            heads = slice(r * h + grp * hg, r * h + (grp + 1) * hg)
            got = y[r].permute(1, 0, 2)[grp * hg:(grp + 1) * hg].float()
            args = (x[heads], dt[heads], a[heads])
            dd = d[grp * hg:(grp + 1) * hg]  # D of the first row's heads, which the wrapper broadcasts
            want = ssd_scan_ref(*args, bb[r, :, grp][None], cc[r, :, grp][None], dd, heads=hg, chunk=256,
                                split_bf16=True)
            torch.testing.assert_close(got, want.float(), **SPLIT_TOL)
            other = ssd_scan_ref(*args, bb[r, :, 1 - grp][None], cc[r, :, 1 - grp][None], dd, heads=hg,
                                 chunk=256, split_bf16=True)
            assert float((got - other.float()).abs().max()) > 100 * SPLIT_TOL["atol"]
    # and the mixer's plain chunked scan with groups, in float32 on the same bf16 inputs
    plain = tssm.ssd_chunked(xs[:1].float(), dts[:1], a[:h, 0], bb[:1].float(), cc[:1].float(), d[:h, 0],
                             chunk=256)
    torch.testing.assert_close(y[:1].float(), plain, **ssd_tol(torch.bfloat16))


def test_chunk_scan_gives_the_same_bits_back_to_back(cuda):
    # the x ring's mbarriers run through many phases, and C_i . h^T's terms
    # pass through shared memory between named barriers: twenty launches on
    # one instance, one answer
    args = ssd_inputs(cuda, 13, 2, 2048, 32, 64, 128, torch.bfloat16)
    x, dt, a, bb, cc, d = args
    scan = sk.SplitScan(*args, heads=32, chunk=256)
    scan.chunk_state()
    runs = []
    for _ in range(20):
        scan.chunk_scan()
        runs.append(scan.out.clone())
    torch.cuda.synchronize()
    for out in runs[1:]:
        assert torch.equal(out, runs[0])
    want = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=32, chunk=256, split_bf16=True)
    torch.testing.assert_close(runs[0].float(), want.float(), **SPLIT_TOL)


# 16 chunks a head: every unit but those of the first chunk takes C_i . h_c^T
@pytest.mark.parametrize("n", sk.SPLIT_STATE_DIMS)
def test_chunk_scan_over_many_chunks(cuda, n):
    args = ssd_inputs(cuda, n + 14, 2, 4096, 32, 64, n, torch.bfloat16)
    x, dt, a, bb, cc, d = args
    scan = sk.SplitScan(*args, heads=32, chunk=256)
    scan.run()
    torch.cuda.synchronize()
    want = sr.ssd_chunk_scan_ref(x, dt, scan.cum, scan.h, cc, bb, d, heads=32, chunk=256, split_bf16=True)
    torch.testing.assert_close(scan.out.float(), want.float(), **SPLIT_TOL)


def test_split_instance_reads_unaligned_views(cuda):
    # a TMA map needs a 16-byte aligned base: a view 1 element into its storage is copied
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 4, 1, 128, 2, 64, 64, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 != 0
    out = sk.ssd_scan_call(xv, dt, a, bb, cc, d, heads=2, chunk=64)
    assert torch.equal(out, sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=2, chunk=64))


# The wrapper hands the split instance the mixer's (B, S, H, P) x where it
# lies and returns the kernel's (B, S, H, P) output: the kernel reads x and
# writes y with the heads interleaved along each sequence row.  Bit for bit
# the flat path's (x flattened, the flat launch, its output permuted back):
# (batch, seq, heads, state, groups of B and C, chunk, x 16-byte aligned)
LAYOUT_CASES = {
    "mamba2-370m's heads": (2, 2048, 32, 128, 1, 256, True),
    "zamba2-7b-instruct's groups": (1, 4096, 112, 64, 2, 256, True),
    "a sequence shorter than a chunk": (2, 100, 32, 128, 1, 256, True),
    # ragged tiles in every chunk, and the last tile past the sequence's end
    "a chunk not a multiple of 64": (2, 100, 9, 64, 1, 20, True),
    "an x not 16-byte aligned": (2, 256, 32, 128, 1, 128, False),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_wrapper_reads_the_mixers_layout_bit_equal_to_the_flat_path(cuda, case):
    b, s, h, n, g, chunk, aligned = LAYOUT_CASES[case]
    gen = torch.Generator(cuda).manual_seed(s + h + n + chunk)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    x = normal(b, s, h, 64).bfloat16()
    dt = torch.nn.functional.softplus(normal(b, s, h))
    A, D = -torch.exp(normal(h)), normal(h)
    B, C = (normal(*((b, s, n) if g == 1 else (b, s, g, n))).bfloat16() for _ in range(2))
    if not aligned:  # a view one element into its storage
        xv = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
        xv.copy_(x)
        x = xv
    assert (x.data_ptr() % 16 == 0) == aligned
    launches.reset()
    got = ss.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    assert launches.by("ssd_scan", "layout") == {"bshp": 1}
    assert launches.by("ssd_scan", "instance") == {"split": 1}
    assert got.shape == (b, s, h, 64) and got.is_contiguous() and got.dtype == torch.bfloat16
    xf, dtf, af, df = ss.ops.flatten(x, dt, A, D)
    if g > 1:
        B, C = (t.permute(0, 2, 1, 3).reshape(b * g, s, n).contiguous() for t in (B, C))
    want = sk.ssd_scan_call(xf.contiguous(), dtf.contiguous(), af.contiguous(), B, C, df.contiguous(),
                            heads=h // g, chunk=chunk)
    torch.cuda.synchronize()
    assert launches.by("ssd_scan", "layout") == {"bshp": 1, "flat": 1}  # the direct flat call's
    assert torch.equal(got, want.reshape(b, h, s, 64).permute(0, 2, 1, 3))


def test_kernel_call_flattens_the_mixers_layout_for_the_fwd_instance(cuda):
    # ssd_scan_fwd reads the flat layout: a (B, S, H, P) x is flattened for it,
    # and its output comes back in x's layout
    x, dt, a, bb, cc, d = ssd_inputs(cuda, 6, 2, 64, 3, 16, 8, torch.float32)
    x4 = x.reshape(2, 3, 64, 16).permute(0, 2, 1, 3).contiguous()
    launches.reset()
    out = sk.ssd_scan_call(x4, dt, a, bb, cc, d, heads=3, chunk=32)
    flat = sk.ssd_scan_call(x, dt, a, bb, cc, d, heads=3, chunk=32)
    torch.cuda.synchronize()
    assert launches.by("ssd_scan", "layout") == {"flat": 2}
    assert launches.by("ssd_scan", "instance") == {"fwd": 2}
    assert out.shape == x4.shape and out.is_contiguous()
    assert torch.equal(out, flat.reshape(2, 3, 64, 16).permute(0, 2, 1, 3))


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
        launches.reset()
        with torch.no_grad():
            losses[dev] = float(train_loss(params.to(dev), cfg, batch)[0])
        assert launches.snapshot()["ssd_scan"] == (cfg.n_layers if dev == "cuda" else 0)
    assert losses["cuda"] == pytest.approx(losses["cpu"], abs=1e-4)


# The mixer's causal convolution (attn_impl="pallas"): the kernel against the
# plain version on the card, bit for bit, at mamba2-370m's scoring widths (x
# 2048 channels, B and C 128), zamba2-7b's (7168 and 64), at sequences
# shorter than the window, of one row past a tile, and of the cell's 2048.
CONV_WIDTHS = (2048, 128, 7168, 64)
CONV_LENGTHS = (1, 2, 3, 4, 257, 2048)


def conv_inputs(cuda, seed: int, b: int, s: int, c: int, k: int, dtype):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, w, bias = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                  for shape in ((b, s, c), (k, c), (c,)))
    return x, w, bias


def assert_bit_equal(out: torch.Tensor, ref: torch.Tensor) -> None:
    assert out.dtype == ref.dtype and out.shape == ref.shape and out.is_contiguous()
    assert torch.equal(out, ref), (
        f"{int((out != ref).sum())} of {out.numel()} elements differ, max |kernel - plain| "
        f"{float((out.float() - ref.float()).abs().max()):.3g}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", CONV_WIDTHS)
@pytest.mark.parametrize("s", CONV_LENGTHS)
def test_conv_kernel_equals_plain_version(cuda, dtype, c, s):
    x, w, bias = conv_inputs(cuda, c + s, 3, s, c, 4, dtype)
    out = ck.causal_conv1d_call(x, w, bias)
    ref = cc.ref.causal_conv1d(x, w, bias)
    torch.cuda.synchronize()
    assert_bit_equal(out, ref)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_conv_kernel_refuses_other_tap_counts(cuda, k):
    """Only K = 4 (every config's d_conv) is built; on the CPU any K is the plain version's."""
    x, w, bias = conv_inputs(cuda, k, 2, 16, 16, k, torch.bfloat16)
    with pytest.raises(ValueError, match="K = 4"):
        ck.causal_conv1d_call(x, w, bias)
    cpu = (x.cpu(), w.cpu(), bias.cpu())
    assert torch.equal(cc.causal_conv1d(*cpu), cc.ref.causal_conv1d(*cpu))


def test_conv_kernel_takes_any_multiple_of_its_four_channels(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for c in (4, 12, 20):
            x, w, bias = conv_inputs(cuda, c, 2, 67, c, 4, dtype)
            assert_bit_equal(ck.causal_conv1d_call(x, w, bias), cc.ref.causal_conv1d(x, w, bias))


def test_conv_wrapper_counts_launches_and_refuses_what_the_kernel_does_not_take(cuda):
    x, w, bias = conv_inputs(cuda, 0, 2, 16, 16, 4, torch.bfloat16)
    launches.reset()
    out = cc.causal_conv1d(x, w.float(), bias.float())  # weights cast to x's type, as plain
    assert launches.snapshot() == {"causal_conv1d": 1}
    assert_bit_equal(out, cc.ref.causal_conv1d(x, w.float(), bias.float()))
    x10, w10, b10 = conv_inputs(cuda, 1, 2, 16, 10, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        cc.causal_conv1d(x10, w10, b10)
    x5, w5, b5 = conv_inputs(cuda, 2, 2, 16, 16, 5, torch.bfloat16)
    with pytest.raises(ValueError, match="K = 4"):
        cc.causal_conv1d(x5, w5, b5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cc.causal_conv1d(x.half(), w.half(), bias.half())
    assert launches.snapshot() == {"causal_conv1d": 1}
    cpu = cc.causal_conv1d(x.cpu(), w.cpu(), bias.cpu())
    assert launches.snapshot() == {"causal_conv1d": 1}
    assert cpu.shape == out.shape
    with pytest.raises(NotImplementedError, match="no VJP"):
        cc.causal_conv1d(x.float().requires_grad_(True), w.float(), bias.float()).sum().backward()


def test_scoring_mamba2_370m_launches_the_conv_kernel_three_times_a_layer(cuda):
    """A scored batch of mamba2-370m at full width: 3 x 48 = 144 launches
    under "pallas", none under "naive", which keeps the plain convolution."""
    cfg = get_config("mamba2-370m")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (2, 257)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    for impl, want in (("pallas", 144), ("naive", 0)):
        launches.reset()
        with torch.no_grad():
            loss = float(train_loss(params, dataclasses.replace(cfg, attn_impl=impl), batch)[0])
        assert np.isfinite(loss)
        assert launches.snapshot()["causal_conv1d"] == want and 3 * cfg.n_layers == 144


# The one-pass RMSNorm (attn_impl="pallas"): the kernel against the plain
# versions on the card, at the cells' group widths (mamba2-370m's 1024 and
# 2048, zamba2-7b-instruct's 3584 as one group and as 2 groups of 7168, and
# 7168), with and without the gate, at one token, one past 256 and 2048.
# chip_smoke.held_norm says what is held and why (NORM_ULPS, NORM_DIFFER).
NORM_CASES = ((1, 1024), (1, 2048), (1, 3584), (2, 3584), (1, 7168))  # (groups, group width)
NORM_LENGTHS = (1, 257, 2048)


def norm_inputs(cuda, seed: int, b: int, s: int, d: int, dtype, gated: bool):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, z = ((torch.randn((b, s, d), generator=gen, device=cuda) * 2).to(dtype) for _ in range(2))
    scale = torch.randn((d,), generator=gen, device=cuda).to(dtype)
    return x, (z if gated else None), scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups,width", NORM_CASES)
@pytest.mark.parametrize("s", NORM_LENGTHS)
@pytest.mark.parametrize("gated", [False, True])
def test_norm_kernel_is_within_one_ulp_of_the_plain_version(cuda, dtype, groups, width, s, gated):
    x, z, scale = norm_inputs(cuda, width + s + groups, 2, s, groups * width, dtype, gated)
    got = chip_smoke.held_norm(x, scale, 1e-5, z, groups)
    torch.cuda.synchronize()
    assert got["max_ulps"] <= chip_smoke.NORM_ULPS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_kernel_takes_any_multiple_of_eight_channels(cuda, dtype):
    """The narrowest groups, groups that leave threads idle, and groups wider
    than the registers hold, whose vectors past them are read twice."""
    for width in (8, 16, 24, 40, 1000, 8200, 20480):
        for gated in (False, True):
            x, z, scale = norm_inputs(cuda, width, 3, 5, width, dtype, gated)
            chip_smoke.held_norm(x, scale, 1e-5, z, 1)


def test_norm_wrappers_count_launches_and_refuse_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import rms_norm as rn

    x, z, scale = norm_inputs(cuda, 0, 2, 16, 64, torch.bfloat16, True)
    launches.reset()
    out = rn.rms_norm(x, scale)
    gated = rn.rms_norm(x, scale, 1e-5, z, 2)
    assert launches.snapshot() == {"rms_norm": 1, "gated_rms_norm": 1}
    assert out.shape == gated.shape == x.shape and out.dtype == torch.bfloat16
    launches.reset()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rn.rms_norm(x.half(), scale.half())
    with pytest.raises(ValueError, match="scale is torch.float32"):
        rn.rms_norm(x, scale.float())  # the plain version would promote to float32
    with pytest.raises(ValueError, match="z is torch.float32"):
        rn.rms_norm(x, scale, 1e-5, z.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        rn.rms_norm(x[..., :12], scale[:12])
    with pytest.raises(ValueError, match="gate of x's shape"):
        rn.rms_norm(x, scale, 1e-5, z[:1])
    assert launches.snapshot() == {}
    cpu = rn.rms_norm(x.cpu(), scale.cpu(), 1e-5, z.cpu(), 2)
    assert launches.snapshot() == {}
    assert torch.equal(cpu, rn.ref.rms_norm(x.cpu(), scale.cpu(), 1e-5, z.cpu(), 2))
    with pytest.raises(NotImplementedError, match="no VJP"):
        rn.rms_norm(x.float().requires_grad_(True), scale.float()).sum().backward()


def test_norm_wrapper_runs_a_dtensors_rows_through_the_kernel(cuda):
    """On a one-rank mesh on the card: sharded over its rows, each rank's rows
    go through the kernel, with the kernel's bits; sharded over its width,
    the plain version completes the sums, counted under
    gated_rms_norm.plain_on_card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.kernels import rms_norm as rn

    x, z, scale = norm_inputs(cuda, 1, 2, 16, 64, torch.bfloat16, True)
    want = rn.rms_norm(x, scale, 1e-5, z, 2)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,))
        launches.reset()
        xs, zs = (distribute_tensor(t, mesh, [Shard(0)]) for t in (x, z))
        got = rn.rms_norm(xs, distribute_tensor(scale, mesh, [Replicate()]), 1e-5, zs, 2)
        assert isinstance(got, DTensor) and torch.equal(got.full_tensor(), want)
        assert launches.snapshot() == {"gated_rms_norm": 1}
        xs, zs = (distribute_tensor(t, mesh, [Shard(2)]) for t in (x, z))
        got = rn.rms_norm(xs, distribute_tensor(scale, mesh, [Shard(0)]), 1e-5, zs, 2)
        torch.testing.assert_close(got.full_tensor(), rn.ref.rms_norm(x, scale, 1e-5, z, 2))
        assert launches.snapshot() == {"gated_rms_norm": 1, "gated_rms_norm.plain_on_card": 1}
    finally:
        dist.destroy_process_group()


def test_scoring_mamba2_370m_launches_the_norm_kernel_at_every_norm(cuda):
    """A scored batch of mamba2-370m at full width: 48 + 1 plain launches
    (norm_in, final_norm) and 48 gated under "pallas", none under "naive"."""
    cfg = get_config("mamba2-370m")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (2, 257)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    losses = {}
    for impl, want in (("pallas", (49, 48)), ("naive", (0, 0))):
        launches.reset()
        with torch.no_grad():
            losses[impl] = float(train_loss(params, dataclasses.replace(cfg, attn_impl=impl), batch)[0])
        assert np.isfinite(losses[impl])
        n = launches.snapshot()
        assert (n["rms_norm"], n["gated_rms_norm"]) == want and cfg.n_layers == 48
