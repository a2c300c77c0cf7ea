"""The batched half of the port's on-device sampler (llm_tpu_torch.ops.
sampling) against the JAX package's (llm_tpu.ops.sampling), on seeded numpy
logits [B, V] with no near-ties.

- `batched_sampler`: the static structure equal field by field, every value
  array equal; the mixed-mirostat ValueError; `ensure_value_keys`.
- The per-row truncations (top-p, min-p, tail-free, typical, top-a) with a
  value a row, neutral rows among them: the -inf masks equal and the kept
  values exact.
- `_apply_penalties` with per-stream values within rtol = atol = 1e-6 (one
  f32 rounding: XLA may fuse `x - counts * freq` into one multiply-add).
- `_device_sample_batched` through `device_sample_step`: the port is handed
  the reference's uniforms (`jax.random.uniform(key, (B, V), 1e-20, 1.0)`,
  what the reference draws from `key`); tokens equal, mu within atol 1e-5
  (the f32 `log` and `exp2` of the two libraries).
- `collect_mu` / `store_mu`: a trajectory is cut at each stream's kept
  count."""

from dataclasses import fields
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.ops import sampling as js
from llm_tpu_torch.ops import sampling as ts

V = 96
B = 5
MU_TOL = dict(rtol=0, atol=1e-5)
PENALTY_TOL = dict(rtol=1e-6, atol=1e-6)  # one f32 rounding (an FMA)


def _logits(seed=0, rows=B):
    return (np.random.default_rng(seed).normal(size=(rows, V)) * 3.0
            ).astype(np.float32)


def _uniforms(key, shape=(B, V)):
    return np.array(jax.random.uniform(key, shape, minval=1e-20, maxval=1.0))


def _same_truncation(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    kept = ~np.isneginf(ref)
    assert np.array_equal(got[kept], ref[kept])
    assert kept.any(axis=-1).all()


BIAS = ((3, 1.5), (7, float("-inf")))
MIXES = {
    "greedy_penalties": [dict(), dict(repeat_penalty=1.3, bias=BIAS), None,
                         dict(frequency_penalty=0.2, presence_penalty=0.1,
                              penalty_last_n=8)],
    "sampled": [dict(kind="sample", temperature=0.7, top_k=12),
                dict(kind="sample", temperature=1.3, top_p=0.8, min_p=0.05),
                dict(), None,
                dict(kind="sample", temperature=0.9, tail_free_z=0.9,
                     typical_p=0.7, top_a=(0.2, 2.0), bias=BIAS)],
    "mirostat1": [dict(kind="sample", temperature=0.8, mirostat=1,
                       mirostat_m=20),
                  dict(kind="sample", temperature=1.1, mirostat=1,
                       mirostat_tau=3.0, mirostat_m=60),
                  dict(kind="sample", temperature=0.6, top_k=9), None],
    "mirostat2": [dict(kind="sample", temperature=0.8, mirostat=2,
                       mirostat_eta=0.2),
                  dict(), dict(kind="sample", temperature=1.2, top_p=0.9),
                  None, dict(kind="sample", mirostat=2, mirostat_tau=4.0)],
}


def _batch(mix):
    j = [None if kw is None else js.DeviceSampler(**kw) for kw in mix]
    t = [None if kw is None else ts.DeviceSampler(**kw) for kw in mix]
    return j, t


@pytest.mark.parametrize("mix", list(MIXES))
def test_batched_sampler_matches_reference(mix):
    j, t = _batch(MIXES[mix])
    jcfg, jvals = js.batched_sampler(j, len(j))
    tcfg, tvals = ts.batched_sampler(t, len(t))
    for f in fields(js.BatchedDeviceSampler):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert list(tvals) == list(jvals)
    for k in jvals:
        assert tvals[k].numpy().dtype == np.asarray(jvals[k]).dtype, k
        assert np.array_equal(tvals[k].numpy(), np.asarray(jvals[k])), k
    hash(tcfg)  # a graph key


def test_batched_sampler_rejects_mixed_mirostat():
    mix = [dict(kind="sample", mirostat=1), dict(kind="sample", mirostat=2)]
    j, t = _batch(mix)
    with pytest.raises(ValueError) as ref:
        js.batched_sampler(j, 2)
    with pytest.raises(ValueError) as got:
        ts.batched_sampler(t, 2)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("mix", ["mirostat1", "sampled"])
def test_ensure_value_keys_matches_reference(mix):
    """A structure that enables more than the local streams use gets
    neutral values for the missing features."""
    j, t = _batch(MIXES[mix])
    jcfg, _ = js.batched_sampler(j, len(j))
    tcfg, _ = ts.batched_sampler(t, len(t))
    jbase, tbase = js.batched_sampler([None] * 4, 4)[1], \
        ts.batched_sampler([None] * 4, 4)[1]
    jv = js.ensure_value_keys(jbase, jcfg, 4)
    tv = ts.ensure_value_keys(tbase, tcfg, 4)
    assert sorted(tv) == sorted(jv)
    for k in jv:
        assert np.array_equal(tv[k].numpy(), np.asarray(jv[k])), k


ROWS = {  # a value a row, neutral rows among them
    "top_p": [0.3, 1.0, 0.7, 0.95, 1.0],
    "min_p": [0.02, 0.0, 0.1, 0.5, 0.0],
    "tail_free": [0.3, 1.0, 0.8, 0.99, 1.0],
    "typical": [0.2, 1.0, 0.6, 0.95, 1.0],
}
JFN = {"top_p": js._top_p_truncate, "min_p": js._min_p_truncate,
       "tail_free": js._tail_free_truncate, "typical": js._typical_truncate}
TFN = {"top_p": ts._top_p_truncate, "min_p": ts._min_p_truncate,
       "tail_free": ts._tail_free_truncate, "typical": ts._typical_truncate}


@pytest.mark.parametrize("name", list(ROWS))
def test_per_row_truncations(name):
    x = _logits(11)
    vals = np.asarray(ROWS[name], np.float32)
    ref = jax.jit(JFN[name])(jnp.asarray(x), jnp.asarray(vals))
    got = TFN[name](torch.from_numpy(x), torch.from_numpy(vals))
    _same_truncation(got, ref)
    neutral = vals == (0.0 if name == "min_p" else 1.0)
    assert not np.isneginf(np.asarray(got)[neutral]).any()


def test_per_row_top_a():
    x = _logits(12)
    a1 = np.asarray([0.2, 0.0, 0.5, 9.0, 0.1], np.float32)
    a2 = np.asarray([2.0, 0.0, 1.0, 1.0, 3.0], np.float32)
    ref = jax.jit(js._top_a_truncate)(jnp.asarray(x), jnp.asarray(a1),
                                      jnp.asarray(a2))
    got = ts._top_a_truncate(torch.from_numpy(x), torch.from_numpy(a1),
                             torch.from_numpy(a2))
    _same_truncation(got, ref)
    assert not np.isneginf(np.asarray(got)[1]).any()  # (0, 0) is off


def _penalty_states(hist, last_n):
    return (js.penalty_state(hist, last_n, V),
            ts.penalty_state(hist, last_n, V))


HIST = [[1, 2, 2, 5], [], [9, 9, 9, 4, 1], [7], list(range(20))]


def test_apply_penalties_per_stream():
    j, t = _batch(MIXES["greedy_penalties"] + [dict(repeat_penalty=1.7)])
    jcfg, jv = js.batched_sampler(j, 5)
    tcfg, tv = ts.batched_sampler(t, 5)
    jst, tst = _penalty_states(HIST, jcfg.penalty_last_n)
    x = _logits(13)
    ref = jax.jit(lambda a, s, v: js._apply_penalties(a, s, jcfg, v))(
        jnp.asarray(x), jst, jv)
    got = ts._apply_penalties(torch.from_numpy(x), tst, tcfg, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PENALTY_TOL)


def _run_pair(jcfg, jv, tcfg, tv, x, key, jst=None, tst=None):
    ref_tok, ref_st = jax.jit(
        lambda a, k, v, s: js.device_sample_step(a, k, jcfg, v, s))(
        jnp.asarray(x), key, jv, jst)
    u = torch.from_numpy(_uniforms(key, x.shape))
    got_tok, got_st = ts.device_sample_step(torch.from_numpy(x), u, tcfg,
                                            tst, values=tv)
    return (np.asarray(ref_tok), ref_st), (got_tok.numpy(), got_st)


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_sample_batched_matches_reference(mix, seed):
    """Every feature of a mix at once, each stream its own values; the
    penalty window and mu carried as the decode loops carry them."""
    j, t = _batch(MIXES[mix])
    n = len(j)
    jcfg, jv = js.batched_sampler(j, n)
    tcfg, tv = ts.batched_sampler(t, n)
    jst, tst = None, None
    if jcfg.any_penalty:
        jst, tst = _penalty_states(HIST[:n], jcfg.penalty_last_n)
    if jcfg.mirostat_kind:
        mu = np.linspace(4.0, 9.0, n).astype(np.float32)
        jst = {**(jst or {}), "mu": jnp.asarray(mu)}
        tst = {**(tst or {}), "mu": torch.from_numpy(mu)}
    x = _logits(20 + seed, n)
    key = jax.random.PRNGKey(seed)
    for step in range(3):  # the state advances between steps
        key, sub = jax.random.split(key)
        (rt, rst), (gt, gst) = _run_pair(jcfg, jv, tcfg, tv, x, sub, jst,
                                         tst)
        assert gt.dtype == np.int32 and gt.tolist() == rt.tolist(), step
        if jst is not None:
            assert set(gst) == set(rst)
            for k in ("counts", "ring", "pos"):
                if k in rst:
                    assert np.array_equal(gst[k].numpy(),
                                          np.asarray(rst[k])), k
            if "mu" in rst:
                np.testing.assert_allclose(gst["mu"].numpy(),
                                           np.asarray(rst["mu"]), **MU_TOL)
        jst, tst = rst, gst
        x = np.roll(x, 7, axis=1)


def test_device_sample_batched_greedy_rows():
    """A sampled structure with temperature-0 rows: those rows take the
    argmax whatever the noise; a greedy structure reads no uniforms."""
    j, t = _batch([dict(kind="sample", temperature=0.0, top_k=5),
                   dict(kind="sample", temperature=2.0), dict()])
    tcfg, tv = ts.batched_sampler(t, 3)
    x = _logits(30, 3)
    for seed in range(4):
        u = torch.from_numpy(_uniforms(jax.random.PRNGKey(seed), (3, V)))
        tok = ts.device_sample(torch.from_numpy(x), u, tcfg, values=tv)
        assert tok[0] == np.argmax(x[0]) and tok[2] == np.argmax(x[2])
    gcfg, gv = ts.batched_sampler([ts.DeviceSampler(bias=BIAS)] * 3, 3)
    assert not gcfg.sample
    tok = ts.device_sample(torch.from_numpy(x), None, gcfg, values=gv)
    want = x.copy()
    want[:, 3] += 1.5
    want[:, 7] = -np.inf
    assert tok.tolist() == np.argmax(want, axis=-1).tolist()


def test_collect_and_store_mu():
    """collect_mu starts a stream's first block at 2 * tau; store_mu keeps
    a trajectory's row at each stream's kept count, or a final row."""
    def stream(ds, mu=None):
        return SimpleNamespace(request=SimpleNamespace(device_sampler=ds),
                               mirostat_mu=mu)

    m2 = ts.DeviceSampler(kind="sample", mirostat=2, mirostat_tau=3.0)
    active = [(0, stream(m2)), (2, stream(m2, 7.5)),
              (3, stream(ts.DeviceSampler()))]
    jactive = [(0, stream(js.DeviceSampler(kind="sample", mirostat=2,
                                           mirostat_tau=3.0))),
               (2, stream(m2, 7.5)), (3, stream(js.DeviceSampler()))]
    got = ts.collect_mu(active, 4)
    ref = js.collect_mu(jactive, 4)
    assert np.array_equal(got, ref) and got.tolist() == [6.0, 0, 7.5, 0]
    traj = np.arange(24, dtype=np.float32).reshape(6, 4)
    keeps = {0: 2, 2: 6, 3: 1}
    ts.store_mu(active, traj, keeps)
    js.store_mu(jactive, traj, keeps)
    assert [s.mirostat_mu for _, s in active] == \
        [s.mirostat_mu for _, s in jactive] == [4.0, 22.0, None]
    ts.store_mu(active, traj[-1])
    assert [s.mirostat_mu for _, s in active[:2]] == [20.0, 22.0]
