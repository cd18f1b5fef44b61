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
    # NVIDIA H100 SXM at 700 W: bf16 dense, HBM3, float32 off the tensor
    # cores, NVLink 4 one way (900 GB/s both ways)
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "f32_flops": 67e12, "link_bw": 450e9}
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


# ------------------------------------------------ the dry run's roofline terms
HLO = """HloModule step
ENTRY %main (p0: f32[1024,512], p1: bf16[64,128]) -> f32[1024,512] {
  %p0 = f32[1024,512]{1,0} parameter(0)
  %p1 = bf16[64,128]{1,0} parameter(1)
  %ar = f32[1024,512]{1,0} all-reduce(%p0), replica_groups={{0,1}}, to_apply=%add
  %ag = bf16[256,128]{1,0} all-gather(%p1), dimensions={0}
  %rs = f32[256,512]{1,0} reduce-scatter(%p0), dimensions={0}, to_apply=%add
  %a2a = bf16[64,128]{1,0} all-to-all(%p1), dimensions={0}
  %cp = bf16[64,128]{1,0} collective-permute(%p1), source_target_pairs={{0,1}}
  %ars = f32[1024,512]{1,0} all-reduce-start(%p0), to_apply=%add
  %ard = f32[1024,512]{1,0} all-reduce-done(%ars)
  ROOT %out = f32[1024,512]{1,0} add(%ar, %ard)
}
"""


def test_parse_collectives_equals_the_reference_on_every_collective():
    from repro.roofline.analysis import parse_collectives as jparse_collectives
    from repro_torch.roofline import parse_collectives

    ours = parse_collectives(HLO)
    assert ours == jparse_collectives(HLO)
    assert ours["counts"] == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
                              "all-to-all": 1, "collective-permute": 1}
    # the ring convention: all-reduce 2x operand, all-gather result, the rest operand
    assert ours["bytes_by_op"]["all-reduce"] == 2 * 2 * 1024 * 512 * 4
    assert ours["bytes_by_op"]["all-gather"] == 256 * 128 * 2


def test_roofline_equals_the_reference_on_the_h100_model(monkeypatch):
    from repro.roofline import analysis as janalysis
    from repro_torch.roofline import roofline

    monkeypatch.setattr(janalysis, "HW", {"peak_flops": HW["peak_flops"], "hbm_bw": HW["hbm_bw"],
                                          "ici_bw": HW["link_bw"]})
    rng = np.random.default_rng(0)
    for _ in range(20):
        kw = dict(arch="a", shape="s", mesh="pod16x16", chips=int(rng.integers(1, 512)),
                  cost={"flops": float(rng.uniform(1e9, 1e15)),
                        "bytes accessed": float(rng.uniform(1e6, 1e13))},
                  collectives={"total_bytes": float(rng.uniform(0, 1e12))},
                  model_flops=float(rng.uniform(1e9, 1e18)))
        ours, theirs = roofline(**kw).as_dict(), janalysis.roofline(**kw).as_dict()
        assert ours == theirs
        assert ours["collective_s"] == kw["collectives"]["total_bytes"] / HW["link_bw"]


def test_model_flops_for_equals_the_reference_for_every_cell():
    from repro.configs import ASSIGNED
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.roofline.analysis import model_flops_for as jmodel_flops_for
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.roofline import model_flops_for

    for arch in ASSIGNED:
        for name, shape in SHAPES.items():
            assert model_flops_for(get_config(arch), shape) == \
                jmodel_flops_for(jget_config(arch), JSHAPES[name]), (arch, name)
