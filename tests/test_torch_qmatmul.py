"""The port's qmatmul (llm_tpu_torch.ops.qmatmul) against the TPU kernels it
replaces, run in Pallas interpret mode on the CPU: K1 (`_qmatmul_pallas`,
`_qmatmul_pallas_stacked`) over planes and K3 (`_qmatmul_pallas_c`) over a
coalesced weight. On the CPU the port runs its plain version, x @ dequant(W)
in f32.

Tolerances:
- plain vs the TPU kernels: the kernels round x and every dequantized weight
  to bf16 (relative error <= 2^-9 each) and sum the products in f32, so
  |y_plain - y_kernel| <= 2^-8 * (|x| @ |W|) + f32 summation error. The test
  holds it to 2^-7 * (|x| @ |W|) + 1e-5.
- the bf16-rounded plain math (what csrc/qmatmul.cu computes) vs the TPU
  kernels: only the f32 summation order differs, so 1e-5 * max|y|, the
  tolerance the JAX package's own kernel tests use."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.ggml.types import GgmlType
from llm_tpu.ops import packing as jpk
from llm_tpu.ops.qmatmul import (
    _qmatmul_pallas,
    _qmatmul_pallas_c,
    _qmatmul_pallas_stacked,
    coalesce_auto,
)
from llm_tpu.ops.qmatmul import quant_rows_lookup as j_rows_lookup
from llm_tpu_torch.ops import packing as tpk
from llm_tpu_torch.ops import qmatmul as tqm
from test_torch_packing import ALL_TYPES, random_raw


def to_port(jq) -> tpk.QuantTensor:
    """A JAX QuantTensor's planes as a port QuantTensor (same bits)."""

    def t(p):
        if p is None:
            return None
        a = np.asarray(p)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a))

    return tpk.QuantTensor(jq.fmt_name, jq.k, jq.r, t(jq.lo), t(jq.hi),
                           t(jq.scale), t(jq.bias), jq.splits)


def bf16_math(x: np.ndarray, tq) -> np.ndarray:
    """x and dequant(W) rounded to bf16, products summed in f32."""
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    wb = tpk.dequant(tq).to(torch.bfloat16).to(torch.float32)
    return (xb @ wb).numpy()


def assert_kernel_close(y_plain, y_kernel, y_bf16, x, tq):
    bound = np.abs(x) @ np.abs(tpk.dequant(tq).numpy())
    err = np.abs(y_plain - y_kernel)
    assert (err <= 2.0**-7 * bound + 1e-5).all(), float(err.max())
    scale = max(float(np.abs(y_kernel).max()), 1.0)
    np.testing.assert_allclose(y_bf16, y_kernel, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_plain_matches_k1_interpret(t):
    K, R, M = 512, 200, 3
    raw = random_raw(t, K, R, seed=21)
    jq = jpk.pack_ggml(t, raw, (K, R))
    tq = tpk.pack_ggml(t, raw, (K, R))
    x = np.random.default_rng(22).standard_normal((M, K)).astype(np.float32)

    launches = tqm.LAUNCHES
    y = tqm.qmatmul(torch.from_numpy(x), tq)
    assert tqm.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert y.shape == (M, R) and y.dtype == torch.float32
    y_k1 = np.asarray(_qmatmul_pallas(jnp.asarray(x), jq, tile_r=128,
                                      tile_k=256, interpret=True))
    assert_kernel_close(y.numpy(), y_k1, bf16_math(x, tq), x, tq)


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q5_1, GgmlType.Q4_K],
                         ids=lambda t: t.name)
def test_stacked_layer_matches_k1_stacked(t):
    K, R, M, L = 256, 128, 2, 3
    raws = [random_raw(t, K, R, seed=30 + l) for l in range(L)]
    jqs = [jpk.pack_ggml(t, raw, (K, R)) for raw in raws]
    tqs = [tpk.pack_ggml(t, raw, (K, R)) for raw in raws]

    def stack(qs, cat):
        return type(qs[0])(
            qs[0].fmt_name, K, R,
            *(None if getattr(qs[0], n) is None
              else cat([getattr(q, n) for q in qs])
              for n in ("lo", "hi", "scale", "bias")))

    js, ts = stack(jqs, jnp.stack), stack(tqs, torch.stack)
    x = np.random.default_rng(3).standard_normal((M, K)).astype(np.float32)
    for layer in range(L):
        y = tqm.qmatmul(torch.from_numpy(x), ts, layer=layer).numpy()
        np.testing.assert_array_equal(
            y, tqm.qmatmul(torch.from_numpy(x), tqs[layer]).numpy())
        y_k1 = np.asarray(_qmatmul_pallas_stacked(
            jnp.asarray(x), js, jnp.int32(layer), tile_r=128, tile_k=128,
            interpret=True))
        assert_kernel_close(y, y_k1, bf16_math(x, tqs[layer]), x,
                            tqs[layer])


def test_layer_view_shares_storage():
    t = GgmlType.Q4_0
    tqs = [tpk.pack_ggml(t, random_raw(t, 256, 128, seed=s), (256, 128))
           for s in range(2)]
    st = tpk.QuantTensor(t.name.lower(), 256, 128,
                         torch.stack([q.lo for q in tqs]), None,
                         torch.stack([q.scale for q in tqs]), None)
    one = st.layer(1)
    assert one.lo.data_ptr() == st.lo[1].data_ptr()
    assert one.lo.is_contiguous() and one.scale.is_contiguous()


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q6_K],
                         ids=lambda t: t.name)
def test_plain_matches_k3_coalesced_interpret(t):
    K, R, M = 2048, 256, 2
    jq = jpk.pack_ggml(t, random_raw(t, K, R, seed=40), (K, R))
    qtc = coalesce_auto(jq)
    assert qtc is not None  # K >= 2048: the layout the 7B weights use
    # the coalesced buffer carries the same function as the planes
    tq = to_port(jpk.uncoalesce_qt(qtc))
    np.testing.assert_array_equal(tpk.dequant(tq).numpy(),
                                  np.asarray(jpk.dequant_jnp(jq)))
    x = np.random.default_rng(41).standard_normal((M, K)).astype(np.float32)
    y = tqm.qmatmul(torch.from_numpy(x), tq).numpy()
    y_k3 = np.asarray(_qmatmul_pallas_c(jnp.asarray(x), qtc, interpret=True))
    assert_kernel_close(y, y_k3, bf16_math(x, tq), x, tq)


def test_leading_dims_and_dense_weights():
    rng = np.random.default_rng(5)
    t = GgmlType.Q8_0
    tq = tpk.pack_ggml(t, random_raw(t, 64, 40, seed=6), (64, 40))
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    y = tqm.qmatmul(torch.from_numpy(x), tq)
    assert y.shape == (2, 3, 40)
    np.testing.assert_allclose(
        y.numpy().reshape(6, 40),
        x.reshape(6, 64) @ tpk.dequant(tq).numpy(), rtol=1e-5, atol=1e-5)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    yd = tqm.qmatmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(yd.numpy(), x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q5_0, GgmlType.Q6_K],
                         ids=lambda t: t.name)
def test_quant_rows_lookup_matches(t):
    E, V = 256, 50  # the embedding table is [E, V]: ids select columns
    raw = random_raw(t, E, V, seed=50)
    jq = jpk.pack_ggml(t, raw, (E, V))
    tq = tpk.pack_ggml(t, raw, (E, V))
    ids = np.array([0, 49, 7, 7, 23], np.int64)
    got = tqm.quant_rows_lookup(tq, torch.from_numpy(ids))
    ref = j_rows_lookup(jq, jnp.asarray(ids, jnp.int32))
    assert got.shape == (5, E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
