"""The port's on-device sampler (llm_tpu_torch.ops.sampling) against the
JAX package's (llm_tpu.ops.sampling), on seeded numpy logits with no
near-ties.

- Truncations (top-k through `_sample_core`, top-p, min-p, tail-free,
  typical, top-a): the -inf masks equal and the kept values exact.
- The penalty window (`penalty_state`, `update_penalty_state`) equal.
  `_apply_penalties` within rtol = atol = 1e-6: the reference runs under
  `jax.jit`, as in its decode loop, where XLA turns a division by a config
  constant into a multiplication by its f32 reciprocal (the port does the
  same) and contracts `x - counts * freq` into one fused multiply-add,
  which torch rounds twice: one f32 rounding apart, ~1e-7 relative.
- Picks (`_gumbel_pick`, `device_sample`): the port is handed the
  reference's uniforms (`jax.random.uniform(key, (V,), 1e-20, 1.0)`, what
  the reference draws from `key`), and the picks must be equal.
- Mirostat: tokens equal and mu within atol 1e-5, for the f32 `log` and
  `exp2` of the two libraries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.ops import sampling as js
from llm_tpu_torch.ops import sampling as ts

V = 96
MU_TOL = dict(rtol=0, atol=1e-5)
PENALTY_TOL = dict(rtol=1e-6, atol=1e-6)  # one f32 rounding (an FMA)


def _logits(seed=0, rows=4):
    return (np.random.default_rng(seed).normal(size=(rows, V)) * 3.0
            ).astype(np.float32)


def _uniforms(seed, shape):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=1e-20, maxval=1.0))


def _same_truncation(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    kept = ~np.isneginf(ref)
    assert np.array_equal(got[kept], ref[kept])
    assert kept.any(axis=-1).all()


def _jit(fn):
    return jax.jit(fn)


@pytest.mark.parametrize("p", [0.3, 0.7, 0.95])
def test_top_p_truncate(p):
    x = _logits(1)
    ref = _jit(lambda v: js._top_p_truncate(v, p))(jnp.asarray(x))
    _same_truncation(ts._top_p_truncate(torch.from_numpy(x), p), ref)


@pytest.mark.parametrize("min_p", [0.02, 0.1, 0.5])
def test_min_p_truncate(min_p):
    x = _logits(2)
    ref = _jit(lambda v: js._min_p_truncate(v, min_p))(jnp.asarray(x))
    _same_truncation(ts._min_p_truncate(torch.from_numpy(x), min_p), ref)


@pytest.mark.parametrize("z", [0.3, 0.8, 0.99])
def test_tail_free_truncate(z):
    x = _logits(3)
    ref = _jit(lambda v: js._tail_free_truncate(v, z))(jnp.asarray(x))
    _same_truncation(ts._tail_free_truncate(torch.from_numpy(x), z), ref)


@pytest.mark.parametrize("p", [0.2, 0.6, 0.95])
def test_typical_truncate(p):
    x = _logits(4)
    ref = _jit(lambda v: js._typical_truncate(v, p))(jnp.asarray(x))
    _same_truncation(ts._typical_truncate(torch.from_numpy(x), p), ref)


@pytest.mark.parametrize("a", [(0.2, 2.0), (0.5, 1.0), (0.05, 0.5)])
def test_top_a_truncate(a):
    x = _logits(5)
    ref = _jit(lambda v: js._top_a_truncate(v, *a))(jnp.asarray(x))
    _same_truncation(ts._top_a_truncate(torch.from_numpy(x), *a), ref)


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_through_sample_core(k):
    """Top-k reaches the pick only through _sample_core: over many draws
    of uniforms the picks are equal, and each is among the top k."""
    x = _logits(6, rows=1)[0]
    jcfg = js.DeviceSampler(kind="sample", temperature=2.0, top_k=k)
    tcfg = ts.DeviceSampler(kind="sample", temperature=2.0, top_k=k)
    topk = set(np.argsort(-x)[:k].tolist())
    pick = jax.jit(lambda v, key: js.device_sample(v, key, jcfg))
    for seed in range(24):
        ref = int(pick(jnp.asarray(x), jax.random.PRNGKey(seed)))
        got = int(ts.device_sample(torch.from_numpy(x), torch.tensor(
            _uniforms(seed, (V,))), tcfg))
        assert got == ref and got in topk


def _histories():
    rng = np.random.default_rng(8)
    return [rng.integers(0, V, n).tolist() for n in (0, 5, 64, 150)]


@pytest.mark.parametrize("last_n,floor", [(64, 0), (16, 0), (0, 0), (0, 500),
                                          (1 << 30, 0)],
                         ids=["window", "wraps", "unbounded",
                              "unbounded_floor", "sentinel"])
def test_penalty_state(last_n, floor):
    ref = js.penalty_state(_histories(), last_n, V, unbounded_floor=floor)
    got = ts.penalty_state(_histories(), last_n, V, unbounded_floor=floor)
    for k in ("counts", "ring", "pos"):
        assert got[k].dtype == {"counts": torch.float32}.get(k, torch.int32)
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k


@pytest.mark.parametrize("last_n", [16, 0])
def test_update_penalty_state(last_n):
    ref = js.penalty_state(_histories(), last_n, V)
    got = ts.penalty_state(_histories(), last_n, V)
    rng = np.random.default_rng(9)
    for _ in range(20):  # wraps the 16-token window
        toks = rng.integers(0, V, 4).astype(np.int32)
        ref = js.update_penalty_state(ref, jnp.asarray(toks))
        got = ts.update_penalty_state(got, torch.from_numpy(toks))
        for k in ("counts", "ring", "pos"):
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    # the single-stream form: no leading batch dim
    ref1 = {k: v[2] for k, v in ref.items()}
    got1 = {k: v[2] for k, v in got.items()}
    ref1 = js.update_penalty_state(ref1, jnp.int32(7))
    got1 = ts.update_penalty_state(got1, torch.tensor(7, dtype=torch.int32))
    for k in ("counts", "ring", "pos"):
        assert got1[k].shape == tuple(ref1[k].shape)
        assert np.array_equal(got1[k].numpy(), np.asarray(ref1[k])), k


@pytest.mark.parametrize("rep,freq,pres", [(1.3, 0.0, 0.0), (0.7, 0.2, 0.5),
                                           (1.1, 0.05, 0.0)])
def test_apply_penalties(rep, freq, pres):
    kw = dict(repeat_penalty=rep, frequency_penalty=freq,
              presence_penalty=pres, penalty_last_n=32)
    jcfg, tcfg = js.DeviceSampler(**kw), ts.DeviceSampler(**kw)
    x = _logits(10)
    jst = js.penalty_state(_histories(), 32, V)
    tst = ts.penalty_state(_histories(), 32, V)
    ref = _jit(lambda v, c: js._apply_penalties(v, {"counts": c}, jcfg,
                                                None))(jnp.asarray(x),
                                                       jst["counts"])
    got = ts._apply_penalties(torch.from_numpy(x), tst, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PENALTY_TOL)


def test_gumbel_pick():
    x = _logits(11)
    pick = jax.jit(js._gumbel_pick)
    for seed in range(16):
        ref = pick(jnp.asarray(x), jax.random.PRNGKey(seed))
        got = ts._gumbel_pick(torch.from_numpy(x),
                              torch.from_numpy(_uniforms(seed, x.shape)))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref))


CONFIGS = {
    "greedy_bias": dict(kind="greedy", bias=((3, float("-inf")), (5, 2.5))),
    "topk_temp": dict(kind="sample", temperature=0.7, top_k=8),
    "chain": dict(kind="sample", temperature=1.3, top_k=30, tail_free_z=0.95,
                  typical_p=0.9, top_p=0.9, top_a=(0.05, 1.0), min_p=0.02,
                  bias=((1, -1.5),)),
    "penalties": dict(kind="sample", temperature=0.9, repeat_penalty=1.3,
                      frequency_penalty=0.1, presence_penalty=0.2,
                      penalty_last_n=32),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_sample(name):
    jcfg, tcfg = (js.DeviceSampler(**CONFIGS[name]),
                  ts.DeviceSampler(**CONFIGS[name]))
    x = _logits(12, rows=1)[0]
    jst = js.penalty_state(_histories()[2:3], 32, V)
    tst = ts.penalty_state(_histories()[2:3], 32, V)
    jst = {k: v[0] for k, v in jst.items()}
    tst = {k: v[0] for k, v in tst.items()}
    pick = jax.jit(lambda v, key, st: js.device_sample(v, key, jcfg, None,
                                                       st))
    for seed in range(12):
        ref = int(pick(jnp.asarray(x), jax.random.PRNGKey(seed), jst))
        got = ts.device_sample(torch.from_numpy(x), torch.from_numpy(
            _uniforms(seed, (V,))), tcfg, tst)
        assert got.dtype == torch.int32 and int(got) == ref


@pytest.mark.parametrize("kind,m", [(2, 100), (1, 100), (1, 1), (1, 10)])
def test_mirostat_sample(kind, m):
    x = _logits(13) / 0.8
    mu0 = np.array([10.0, 6.0, 3.0, 1.0], np.float32)
    run = jax.jit(lambda v, key, mu: js._mirostat_sample(
        v, key, mu, 5.0, 0.1, kind, m))
    for seed in range(8):
        rtok, rmu = run(jnp.asarray(x), jax.random.PRNGKey(seed),
                        jnp.asarray(mu0))
        tok, mu = ts._mirostat_sample(
            torch.from_numpy(x), torch.from_numpy(_uniforms(seed, x.shape)),
            torch.from_numpy(mu0), 5.0, 0.1, kind, m)
        assert np.array_equal(tok.numpy(), np.asarray(rtok))
        assert np.isfinite(mu.numpy()).all()
        np.testing.assert_allclose(mu.numpy(), np.asarray(rmu), **MU_TOL)


@pytest.mark.parametrize("name,miro", [("penalties", 0), ("mirostat2", 2),
                                       ("mirostat1", 1)])
def test_device_sample_step(name, miro):
    kw = CONFIGS.get(name, dict(kind="sample", temperature=0.8,
                                mirostat=miro, repeat_penalty=1.2,
                                penalty_last_n=16))
    jcfg, tcfg = js.DeviceSampler(**kw), ts.DeviceSampler(**kw)
    last_n = kw["penalty_last_n"]
    jst = {k: v[0] for k, v in js.penalty_state(_histories()[3:], last_n,
                                                V).items()}
    tst = {k: v[0] for k, v in ts.penalty_state(_histories()[3:], last_n,
                                                V).items()}
    if miro:
        jst["mu"] = jnp.float32(js.mirostat_mu_init(jcfg))
        tst["mu"] = torch.tensor(ts.mirostat_mu_init(tcfg))
    step = jax.jit(lambda v, key, st: js.device_sample_step(v, key, jcfg,
                                                            None, st))
    x = _logits(14, rows=1)[0]
    for seed in range(6):
        rtok, jst = step(jnp.asarray(x), jax.random.PRNGKey(seed), jst)
        tok, tst = ts.device_sample_step(torch.from_numpy(x), torch.from_numpy(
            _uniforms(seed, (V,))), tcfg, tst)
        assert int(tok) == int(rtok)
        assert set(tst) == set(jst)
        for k in ("counts", "ring", "pos"):
            assert np.array_equal(tst[k].numpy(), np.asarray(jst[k])), k
        if miro:
            np.testing.assert_allclose(float(tst["mu"]), float(jst["mu"]),
                                       **MU_TOL)


@pytest.mark.parametrize("kw", [dict(mirostat=2, top_k=5),
                                dict(mirostat=1, top_p=0.9),
                                dict(mirostat=2, min_p=0.1),
                                dict(mirostat=1, tail_free_z=0.9),
                                dict(mirostat=2, typical_p=0.5),
                                dict(mirostat=1, top_a=(0.1, 1.0))])
def test_device_sampler_validation(kw):
    with pytest.raises(ValueError) as ref:
        js.DeviceSampler(kind="sample", **kw)
    with pytest.raises(ValueError) as got:
        ts.DeviceSampler(kind="sample", **kw)
    assert str(got.value) == str(ref.value)


def test_device_sampler_properties():
    for kw in (dict(), dict(repeat_penalty=1.1), dict(frequency_penalty=0.1),
               dict(presence_penalty=0.1), dict(kind="sample", mirostat=1)):
        j, t = js.DeviceSampler(**kw), ts.DeviceSampler(**kw)
        assert (t.has_penalties, t.has_mu) == (j.has_penalties, j.has_mu)
    assert ts.DeviceSampler.greedy() == ts.DeviceSampler(kind="greedy")
    t = ts.DeviceSampler.top_k_temperature(12, 0.5)
    j = js.DeviceSampler.top_k_temperature(12, 0.5)
    assert (t.kind, t.top_k, t.temperature) == (j.kind, j.top_k,
                                                j.temperature)
    assert ts.mirostat_mu_init(t) == js.mirostat_mu_init(j)
    assert hash(t) == hash(ts.DeviceSampler.top_k_temperature(12, 0.5))
