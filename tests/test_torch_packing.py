"""The port's weight packing (llm_tpu_torch.ops.packing) against the JAX
package's: the same raw GGML bytes give bit-equal planes and a bit-equal
dequantization, for all 10 formats, fused and unfused, with R and K padding.

Tolerance: none. Packing and dequantization are exact integer and f16->f32
operations in both packages, so every comparison is array equality."""

import numpy as np
import pytest
import torch

from llm_tpu.ggml.quant import quantize
from llm_tpu.ggml.types import GgmlType
from llm_tpu.ops import packing as jpk
from llm_tpu.testing import _random_kquant
from llm_tpu_torch.ops import packing as tpk

ALL_TYPES = list(jpk.FORMATS)
K_QUANTS = {GgmlType.Q2_K, GgmlType.Q3_K, GgmlType.Q4_K, GgmlType.Q5_K,
            GgmlType.Q6_K}


def random_raw(t: GgmlType, K: int, R: int, seed: int) -> bytes:
    """Valid raw block bytes of a [K, R] (ggml dims) tensor of type t."""
    rng = np.random.default_rng(seed)
    if t in K_QUANTS:
        return _random_kquant(rng, t, K * R)
    return quantize(t, (rng.standard_normal(K * R) * 0.1).astype(np.float32))


def plane_bits(p) -> np.ndarray:
    """A plane of either package as a numpy array of its raw bits."""
    if p is None:
        return None
    a = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    return a


def assert_planes_equal(tq, jq):
    assert (tq.fmt_name, tq.k, tq.r) == (jq.fmt_name, jq.k, jq.r)
    assert (tq.k_padded, tq.r_padded) == (jq.k_padded, jq.r_padded)
    assert tq.scale_packed == jq.scale_packed
    assert tq.splits == jq.splits
    for name in ("lo", "hi", "scale", "bias"):
        t, j = plane_bits(getattr(tq, name)), plane_bits(getattr(jq, name))
        assert (t is None) == (j is None), name
        if t is not None:
            assert t.dtype == j.dtype, name
            np.testing.assert_array_equal(t, j, err_msg=name)


def kr_cases(t):
    """(K, R) pairs: R off the 128 lane multiple; for the 32-block formats
    also a K that pads up to the f16-pair / 16g granule, like w_down's
    K=11008 -> Kp=11264."""
    if t in K_QUANTS:
        return [(256, 96), (768, 200)]
    return [(256, 96), (704, 200), (11008, 8)]


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_pack_planes_bit_equal(t):
    for i, (K, R) in enumerate(kr_cases(t)):
        raw = random_raw(t, K, R, seed=i)
        tq = tpk.pack_ggml(t, raw, (K, R))
        jq = jpk.pack_ggml(t, raw, (K, R))
        assert_planes_equal(tq, jq)
        if i == 1:  # the padded case (each jnp shape costs a compile)
            np.testing.assert_array_equal(
                tpk.dequant(tq, trim=False).numpy(),
                np.asarray(jpk.dequant_jnp(jq, trim=False)))
            np.testing.assert_array_equal(tpk.dequant(tq).numpy(),
                                          np.asarray(jpk.dequant_jnp(jq)))


def test_k11008_pads_to_11264_with_zero_scales():
    t = GgmlType.Q4_0
    tq = tpk.pack_ggml(t, random_raw(t, 11008, 8, seed=5), (11008, 8))
    assert tq.k_padded == 11264 and tq.r_padded == 128
    scales = tpk.scale_plane_f32(tq.scale)
    assert bool((scales[11008 // 32:] == 0).all())
    assert bool((scales[:, 8:] == 0).all())


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_row_selection_matches(t):
    K, R = 256, 40
    raw = random_raw(t, K, R, seed=7)
    rows = np.array([5, 0, 39, 17, 17, 2])
    tq = tpk.pack_ggml(t, raw, (K, R), rows=rows)
    jq = jpk.pack_ggml(t, raw, (K, R), rows=rows)
    assert_planes_equal(tq, jq)


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q5_1, GgmlType.Q8_0,
                               GgmlType.Q3_K, GgmlType.Q6_K],
                         ids=lambda t: t.name)
def test_fuse_and_split_match(t):
    K = 256
    widths = (96, 32, 160)  # each member padded to its own 128 multiple
    raws = [random_raw(t, K, r, seed=10 + i) for i, r in enumerate(widths)]
    tqs = [tpk.pack_ggml(t, raw, (K, r)) for raw, r in zip(raws, widths)]
    jqs = [jpk.pack_ggml(t, raw, (K, r)) for raw, r in zip(raws, widths)]
    tf, jf = tpk.fuse_quant(tqs), jpk.fuse_quant(jqs)
    assert_planes_equal(tf, jf)

    y = np.random.default_rng(0).standard_normal((3, tf.r)).astype(np.float32)
    touts = tpk.split_fused(torch.from_numpy(y), tf.splits)
    jouts = jpk.split_fused(y, jf.splits)
    assert [o.shape[-1] for o in touts] == list(widths)
    for to, jo in zip(touts, jouts):
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # a member's columns of the fused dequant are that member's dequant
    for to, q in zip(tpk.split_fused(tpk.dequant(tf), tf.splits), tqs):
        np.testing.assert_array_equal(to.numpy(), tpk.dequant(q).numpy())


def test_fuse_refuses_mixed_formats():
    K = 256
    a = tpk.pack_ggml(GgmlType.Q4_0, random_raw(GgmlType.Q4_0, K, 32, 0),
                      (K, 32))
    b = tpk.pack_ggml(GgmlType.Q8_0, random_raw(GgmlType.Q8_0, K, 32, 1),
                      (K, 32))
    assert tpk.fuse_quant([a, b]) is None


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("signed", [False, True])
def test_unpack_plane_matches(bits, signed):
    rng = np.random.default_rng(bits)
    words = rng.integers(0, 2**32, size=(6, 128), dtype=np.uint64).astype(
        np.uint32)
    got = tpk.unpack_plane(torch.from_numpy(words.view(np.int32)), bits,
                           signed=signed)
    ref = jpk.unpack_plane(words, bits, signed=signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_expand_f16x2_matches():
    vals = np.array([0.0, -0.0, 1.0, -2.5, 65504.0, 6.1e-5, 5.96e-8, -1e-3],
                    np.float16)
    h = vals.view(np.uint16).astype(np.uint32)
    words = (h[0::2] | (h[1::2] << 16)).reshape(4, 1)
    got = tpk.expand_f16x2(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpk.expand_f16x2(words)))
    np.testing.assert_array_equal(got.numpy()[:, 0], vals.astype(np.float32))


def test_dense_pack_matches():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 24)).astype(np.float32)  # [R, K]
    got = tpk.pack_ggml(GgmlType.F32, w.tobytes(), (24, 40))
    assert got.shape == (24, 40)
    np.testing.assert_array_equal(got.numpy(), w.T)
