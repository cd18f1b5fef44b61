"""The Hopper GRIB kernels on the card, against their plain PyTorch version.

Every case needs a CUDA card and ``nvcc``; each is marked ``cuda`` and skips
with a reason where there is none.  This file imports no JAX, so it runs
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import codec  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import grib_pack as gp  # noqa: E402
from repro_torch.kernels.grib_pack import kernel as gk  # noqa: E402
from repro_torch.kernels.grib_pack.ref import field_stats, pack_ref, unpack_ref  # noqa: E402

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
