"""The port's T=1 dense-cache attention pass
(llm_tpu_torch.ops.dense_attention) against the TPU kernel it replaces, K2
(`_dense_attention_call`), run in Pallas interpret mode on the CPU. On the
CPU the port runs its plain version, the block-wise online softmax.

Tolerance: rtol = atol = 1e-5 (relative to max|acc| for acc). Both sides
are f32 throughout; they cut the window into different blocks (TPU kernel:
16 positions, plain: the whole window), so the online-softmax rescaling
and the sums run in another order. The masking constants are exact: a
stream with n_past = 0 gives m = -1e30, l = 0, acc = 0 on both."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.ops.dense_attention import _dense_attention_call
from llm_tpu.ops.layers import alibi_slopes as j_alibi_slopes
from llm_tpu_torch.ops import dense_attention as tda

L, B, S, D, W = 2, 3, 96, 16, 64
BLOCK = 16  # the TPU kernel's block over the window


def make_inputs(kv: str, hkv: int, rep: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (L, B, hkv, S, D)
    if kv == "int8":
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((B, 1, hkv, rep, D)).astype(np.float32)
    return k, v, ks, vs, q


def as_torch(a, kv):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if kv == "bf16" and t.is_floating_point() \
        else t


def as_jax(a, kv):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16) if kv == "bf16" and \
        a.dtype == np.float32 else jnp.asarray(a)


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("rep,alibi", [(1, False), (2, False), (2, True)],
                         ids=["mha", "gqa", "gqa-alibi"])
def test_plain_matches_k2_interpret(kv, rep, alibi):
    hkv = 2
    k, v, ks, vs, q = make_inputs(kv, hkv, rep, seed=rep + 10 * alibi)
    n_past = np.array([0, 37, W], np.int32)  # empty, mid-window, full
    spec = SimpleNamespace(kq_scale=1.0 / np.sqrt(D))
    layer = 1
    slopes = (np.array(j_alibi_slopes(hkv * rep, 8.0)).reshape(hkv, rep)
              if alibi else None)

    launches = tda.LAUNCHES
    m, l, acc = tda.dense_attention_pass(
        spec, as_torch(k, kv), as_torch(v, kv), as_torch(ks, kv),
        as_torch(vs, kv), torch.from_numpy(n_past), W, layer,
        torch.from_numpy(q),
        None if slopes is None else torch.from_numpy(slopes))
    assert tda.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert m.shape == l.shape == (B, 1, hkv, rep)
    assert acc.shape == (B, 1, hkv, rep, D)

    jm, jl, jacc = _dense_attention_call(
        as_jax(k, kv), as_jax(v, kv), as_jax(ks, kv), as_jax(vs, kv),
        jnp.asarray(n_past), None if slopes is None else jnp.asarray(slopes),
        jnp.int32(layer), jnp.asarray(q[:, 0]), window=W,
        kq_scale=float(spec.kq_scale), interpret=True, hkv=hkv, rep=rep,
        d=D, block=BLOCK, hc=hkv)
    np.testing.assert_allclose(m.numpy()[:, 0], np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy()[:, 0], np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    scale = float(np.abs(np.asarray(jacc)).max())
    np.testing.assert_allclose(acc.numpy()[:, 0], np.asarray(jacc),
                               rtol=1e-5, atol=1e-5 * scale)
    # stream 0 has no past: the merge in forward relies on these constants
    assert (m.numpy()[0] == np.float32(tda.NEG_INF)).all()
    assert (l.numpy()[0] == 0).all() and (acc.numpy()[0] == 0).all()


def test_plain_reads_only_the_window():
    """Positions past `window` (and past n_past) never affect the result."""
    kv, hkv, rep = "f32", 2, 1
    k, v, ks, vs, q = make_inputs(kv, hkv, rep, seed=3)
    spec = SimpleNamespace(kq_scale=0.25)
    args = (torch.tensor([40, 64, 5]), W, 0, torch.from_numpy(q))
    ref = tda.dense_attention_pass(spec, torch.from_numpy(k),
                                   torch.from_numpy(v), None, None, *args)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, :, W:] = 1e4
    v2[:, :, :, W:] = -1e4
    k2[:, 2, :, 5:] = 1e4
    got = tda.dense_attention_pass(spec, torch.from_numpy(k2),
                                   torch.from_numpy(v2), None, None, *args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rejects_prefill_shape():
    k, v, _, _, _ = make_inputs("f32", 2, 1, seed=0)
    q = torch.zeros(B, 2, 2, 1, D)
    with pytest.raises(ValueError):
        tda.dense_attention_pass(SimpleNamespace(kq_scale=1.0),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 None, None, torch.zeros(B), W, 0, q)
