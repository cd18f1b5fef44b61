"""The port's roofline package (repro_torch.roofline) against the reference's
codec roofline: the same flops and bytes for every width and both kinds,
both kinds memory-bound on the H100 model, and that model's data-sheet
values.  The reference's TPU table is not carried; the reference's codec
roofline is handed the port's hardware model where the two must agree."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.roofline import codec as jroof  # noqa: E402
from repro_torch.roofline import HW, CodecRoofline, codec_roofline, ridge_intensity  # noqa: E402

SHAPES = ((1, 8, 128), (20, 128, 128), (100, 2048, 128))


def test_hw_holds_the_h100_data_sheet():
    # NVIDIA H100 SXM at 700 W: bf16 dense, HBM3, float32 off the tensor cores
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "f32_flops": 67e12}
    assert ridge_intensity() == pytest.approx(295.22, abs=0.01)
    assert ridge_intensity({"peak_flops": 10.0, "hbm_bw": 4.0}) == 2.5


@pytest.mark.parametrize("kind", ("pack", "unpack"))
def test_flops_and_bytes_match_the_reference_at_every_width(kind):
    for shape in SHAPES:
        for nbits in range(1, 33):
            ours = codec_roofline(kind, shape, nbits=nbits)
            theirs = jroof.codec_roofline(kind, shape, nbits=nbits, hw=HW)
            assert isinstance(ours, CodecRoofline)
            assert ours.as_dict() == theirs.as_dict()
            assert ours.n_elems == int(np.prod(shape))


@pytest.mark.parametrize("kind", ("pack", "unpack"))
def test_both_kinds_are_memory_bound_on_the_h100(kind):
    for nbits in (1, 8, 16, 24, 31):
        r = codec_roofline(kind, (20, 128, 128), nbits=nbits)
        assert r.bound == "memory"
        assert r.intensity < ridge_intensity() / 100
        assert r.memory_s > r.compute_s
        assert r.memory_s == r.hbm_bytes / HW["hbm_bw"]
        assert r.compute_s == r.flops / HW["peak_flops"]


def test_rejects_unknown_kind():
    with pytest.raises(ValueError, match="pack"):
        codec_roofline("transcode", (1, 8, 128))
