"""A decode step's operations and bytes, checked by hand against the
published widths of the configuration."""

import json
from pathlib import Path

import pytest

from portbench.roofline import Work, peaks, shape_of
from portbench.weights import hparams

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def shape(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    return shape_of(cfg, hparams(cfg))


def test_falcon_decode_step_by_hand():
    s = shape("falcon-7b.q4_0")
    # q|k|v: 71 query heads and one key and one value head of 64
    qkv = 64 * (71 + 2)
    weights = 32 * (4544 * qkv + 4544 * 4544 + 2 * 4544 * 18176) \
        + 4544 * 65024
    assert weights == 6_921_420_800
    mm = s.matmul(64, 64)
    assert mm.flops == 2 * 64 * weights
    assert mm.bytes > weights * 18 / 32
    att = s.attention([9], 10)
    assert att.flops == 32 * 4 * 4544 * 10
    assert att.bytes == 32 * (10 * 2 * 64 * 2 + 4544 * 8)


def test_work_counts_live_streams_and_prefill():
    w = Work()
    w.add_block([(100, 3), (50, 1), (7, 0)])
    assert w.decode == [[100, 50], [101], [102]]
    w.prefill.append((0, 64))
    s = shape("falcon-7b.q4_0")
    costs = w.costs(s)
    assert len(costs) == 4
    # the prefill chunk needs the head at its last row only
    assert costs[3][0].flops == s.matmul(64, 1).flops
    b = w.bounds(s, peaks("NVIDIA H100 80GB HBM3"))
    assert 0 < b["matmul"] < b["step"]
    assert 0 < b["decode_attention"] < b["step"]


def test_bound_of_a_one_stream_falcon_step_is_bytes():
    s = shape("falcon-7b.q4_0")
    pk = peaks("NVIDIA H100 80GB HBM3")
    c = s.matmul(1, 1) + s.attention([1100], 1101)
    assert c.bytes / pk[1] > c.flops / pk[0]
    # Q4_0 weights at 18 bytes a 32; bf16 K and V of 1101 positions of
    # one kv head of 64 in 32 layers; q and out in f32; then activations
    weights = 6_921_420_800 * 18 // 32
    kv = 1101 * 2 * 64 * 2 * 32
    qo = 32 * 4544 * 8
    assert weights + kv + qo == 3_903_481_856
    assert c.bytes == pytest.approx(3.9099e9, rel=1e-4)
    assert c.bound_s(pk) == pytest.approx(c.bytes / 3.35e12)
    assert peaks("no such card") is None
