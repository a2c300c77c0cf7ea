"""The port's paged-pool attention (llm_tpu_torch.ops.paged_attention)
against what it replaces: the TPU kernel K4 (`_paged_attention_call`), run
in Pallas interpret mode on the CPU, for decode steps (T=1), and the
reference's page loop `paged._paged_online_pass` for prefill chunks
(T > 1). On the CPU the port runs its plain version, `paged_attention_plain`.

Inputs are 7B-shaped per head (D = 128) on a small pool: page 16, shuffled
page tables whose unused columns point at the trash page 0, and streams
with n_past 0, mid-page and a full window.

Tolerance: rtol = atol = 1e-5 (relative to max|acc| for acc). Both sides
are f32 throughout, but the TPU kernel folds the quantized scales around
its dots (scores x k_scale, probabilities x v_scale) where the plain version
dequantizes the rows first, and the sums run in another order. The masking
constants are exact: a stream with n_past = 0 gives m = -1e30, l = 0,
acc = 0 on both."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import paged as jpaged
from llm_tpu.ops.layers import alibi_slopes as j_alibi_slopes
from llm_tpu.ops.paged_attention import _paged_attention_call
from llm_tpu_torch.ops import paged_attention as tpa

L, NP, PAGE, D, B, P, WP = 2, 10, 16, 128, 3, 4, 3
N_PAST = np.array([0, 37, WP * PAGE], np.int32)  # empty, mid-page, full
TOL = dict(rtol=1e-5, atol=1e-5)
KV = ["bf16", "f32", "int8", "int4"]
GEOM = [(2, 1, False), (2, 2, True)]  # (Hkv, rep, alibi)
GEOM_IDS = ["mha", "gqa-alibi"]


def make_pool(kv: str, hkv: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (L, NP, hkv, PAGE, D)
    if kv in ("int8", "int4"):
        if kv == "int8":
            k = rng.integers(-127, 128, size=shape).astype(np.int8)
            v = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:  # planar nibble bytes: every byte value is a valid code pair
            half = shape[:-1] + (D // 2,)
            k = rng.integers(0, 256, size=half).astype(np.uint8)
            v = rng.integers(0, 256, size=half).astype(np.uint8)
        ks = rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    # each stream's pages, shuffled over the pool; columns past its pages
    # point at the trash page 0
    perm = rng.permutation(np.arange(1, NP))
    tables = np.zeros((B, P), np.int32)
    tables[1, :3] = perm[:3]
    tables[2, :3] = perm[3:6]
    tables[0, 0] = perm[6]
    return k, v, ks, vs, tables


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


def _slopes(hkv, rep, alibi):
    if not alibi:
        return None
    return np.array(j_alibi_slopes(hkv * rep, 8.0)).reshape(hkv, rep)


def _assert_partials(got, ref, t_axis):
    m, l, acc = (x.numpy() for x in got)
    jm, jl, jacc = (np.asarray(x) for x in ref)
    if not t_axis:  # the TPU kernel's partials carry no T axis
        m, l, acc = m[:, 0], l[:, 0], acc[:, 0]
    assert m.shape == jm.shape and acc.shape == jacc.shape
    np.testing.assert_allclose(m, jm, **TOL)
    np.testing.assert_allclose(l, jl, **TOL)
    scale = float(np.abs(jacc).max())
    np.testing.assert_allclose(acc, jacc, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("hkv,rep,alibi", GEOM, ids=GEOM_IDS)
def test_plain_matches_k4_interpret(kv, hkv, rep, alibi):
    k, v, ks, vs, tables = make_pool(kv, hkv, seed=hkv + 10 * alibi)
    q = np.random.default_rng(5).standard_normal(
        (B, 1, hkv, rep, D)).astype(np.float32)
    spec = SimpleNamespace(kq_scale=1.0 / np.sqrt(D))
    slopes = _slopes(hkv, rep, alibi)
    layer = 1

    launches = tpa.LAUNCHES
    got = tpa.paged_attention_pass(
        spec, as_torch(k, kv), as_torch(v, kv), as_torch(ks, kv),
        as_torch(vs, kv), torch.from_numpy(tables), torch.from_numpy(N_PAST),
        None if slopes is None else torch.from_numpy(slopes), WP, layer,
        torch.from_numpy(q))
    assert tpa.LAUNCHES == launches  # a CPU tensor never reaches the kernel

    ref = _paged_attention_call(
        as_jax(k, kv), as_jax(v, kv), as_jax(ks, kv), as_jax(vs, kv),
        jnp.asarray(tables), jnp.asarray(N_PAST),
        None if slopes is None else jnp.asarray(slopes), jnp.int32(layer),
        jnp.asarray(q[:, 0]), window_pages=WP, kq_scale=float(spec.kq_scale),
        interpret=True, hkv=hkv, rep=rep, d=D)
    _assert_partials(got, ref, t_axis=False)
    # stream 0 has no past: the merge in forward relies on these constants
    m, l, acc = got
    assert (m[0] == tpa.NEG_INF).all()
    assert (l[0] == 0).all() and (acc[0] == 0).all()


@pytest.mark.parametrize("kv", KV)
def test_prefill_page_pass_matches_reference(kv):
    """T > 1: the page loop prefill chunks take, against the reference's."""
    hkv, rep, T = 2, 2, 5
    k, v, ks, vs, tables = make_pool(kv, hkv, seed=7)
    q = np.random.default_rng(8).standard_normal(
        (B, T, hkv, rep, D)).astype(np.float32)
    spec = SimpleNamespace(kq_scale=0.125)
    slopes = _slopes(hkv, rep, True)
    got = tpa.paged_attention_plain(
        spec, as_torch(k, kv), as_torch(v, kv), as_torch(ks, kv),
        as_torch(vs, kv), torch.from_numpy(tables), torch.from_numpy(N_PAST),
        torch.from_numpy(slopes), WP, 0, torch.from_numpy(q))
    ref = jpaged._paged_online_pass(
        spec, jnp.asarray(q), pool_k=as_jax(k, kv), pool_v=as_jax(v, kv),
        ks=as_jax(ks, kv), vs=as_jax(vs, kv), layer=jnp.int32(0),
        tables=jnp.asarray(tables), n_past=jnp.asarray(N_PAST),
        slopes=jnp.asarray(slopes), window_pages=WP)
    _assert_partials(got, ref, t_axis=True)


def test_masked_positions_and_trash_page_are_never_read():
    """Rows at positions >= n_past, on the trash page and on pages no
    table names never change the result."""
    kv, hkv = "int8", 2
    k, v, ks, vs, tables = make_pool(kv, hkv, seed=3)
    q = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 1, hkv, 1, D)).astype(np.float32))
    spec = SimpleNamespace(kq_scale=0.1)
    n_past = torch.tensor([5, 20, 40])

    def run(k, v, ks, vs):
        return tpa.paged_attention_pass(
            spec, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(tables), n_past, None, WP, 1, q)

    ref = run(k, v, ks, vs)
    k2, v2, ks2, vs2 = k.copy(), v.copy(), ks.copy(), vs.copy()
    for b, np_ in enumerate(n_past.tolist()):
        for pos in range(np_, WP * PAGE):
            pid, off = tables[b, pos // PAGE], pos % PAGE
            k2[:, pid, :, off] = 127
            ks2[:, pid, :, off] = 1e3
            vs2[:, pid, :, off] = -1e3
    unused = sorted(set(range(NP)) - set(tables[:, :WP].ravel().tolist()))
    for a in (ks2, vs2):
        a[:, [0] + unused] = 1e4
    got = run(k2, v2, ks2, vs2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_pass_rejects_prefill_shape():
    k, v, _, _, tables = make_pool("f32", 2, seed=0)
    q = torch.zeros(B, 2, 2, 1, D)
    with pytest.raises(ValueError, match="T=1"):
        tpa.paged_attention_pass(
            SimpleNamespace(kq_scale=1.0), torch.from_numpy(k),
            torch.from_numpy(v), None, None, torch.from_numpy(tables),
            torch.from_numpy(N_PAST), None, WP, 0, q)
