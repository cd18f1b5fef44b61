"""The yardstick's arithmetic, pinned to the bounds PERF.md records."""

import json
from pathlib import Path

import pytest

from perfbench import roofline

CONFIG = json.loads((Path(__file__).parent / "configs" / "mamba2-370m.json").read_text())


def test_ssd_bound_at_k4s_main_shape():
    # 8 x 2048 tokens, 32 heads of 64, state 128, chunk 256: 0.0432 ms, by bytes
    t, by = roofline.ssd_bound(bh=8 * 32, s=2048, p=64, n=128, q=256, bg=8, itemsize=2)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.0432, abs=5e-5)
    assert roofline.ssd_bytes(256, 2048, 64, 128, 8, 2) == 144_705_536


def test_attention_bound_at_qwens_shape():
    # q 16 x 2048 x 128, k/v 2 x 2048 x 128, causal: 0.01738 ms, by operations
    t, by = roofline.attention_bound(bh=16, bk=2, sq=2048, sk=2048, d=128, itemsize=2, causal=True)
    assert by == "operations"
    assert t * 1e3 == pytest.approx(0.01738, abs=5e-6)


@pytest.mark.parametrize("sq, sk, causal, q_offset, pairs", [
    (4, 4, True, 0, 10), (4, 4, False, 0, 16), (2, 6, True, 4, 11), (3, 2, True, 0, 5)])
def test_attention_pairs(sq, sk, causal, q_offset, pairs):
    assert roofline.attention_pairs(sq, sk, causal, q_offset) == pairs


def test_ssd_ops_counts_each_term():
    # one chunk: C.B^T once per group and scores.x per head over the causal pairs, no state terms
    assert roofline.ssd_ops(bh=2, s=4, p=3, n=5, q=4, bg=1) == 2 * (10 * 5 + 10 * 3 * 2)
    # two chunks add C.state and the state update once each per head
    assert roofline.ssd_ops(bh=1, s=4, p=3, n=5, q=2, bg=1) == 2 * (3 * 5 * 2 + 3 * 3 * 2 + 2 * 2 * 5 * 3)


def test_model_flops_of_mamba2_370m():
    d = roofline.ssm_dims(CONFIG)
    assert (d["layers"], d["d_inner"], d["heads"], d["vocab"]) == (48, 2048, 32, 50288)
    proj = 1024 * (2 * 2048 + 2 * 128 + 32) + 2048 * 1024
    conv = 4 * (2048 + 2 * 128)
    scan = roofline.ssd_ops(32, 2048, 64, 128, 256, 1) / 2048
    fwd = roofline.forward_flops_per_token(CONFIG, 2048)
    assert fwd == pytest.approx(48 * (2 * proj + 2 * conv + scan) + 2 * 1024 * 50288)
    assert 8.0e8 < fwd < 8.2e8
    assert roofline.train_flops_per_token(CONFIG, 2048) == pytest.approx(3 * fwd)
