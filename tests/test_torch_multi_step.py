"""The port's batched on-device decode loops against the JAX package's, on
a tiny LLaMA Q4_0 checkpoint (2 layers, 4 heads of 16, V = 96):

- `forward.write_cache_batched` with the write mask on the device: a masked
  stream's rows stay as they were;
- `forward.decode_loop_batched` over f32, bf16 and int8 dense caches
  (greedy, a masked slot) and with a heterogeneous sampled batch
  (per-stream temperature, top-k, top-p, penalties, bias, mirostat 2,
  logprobs);
- `paged._fold_block_rows`, `paged.paged_forward_batched(block_kv=,
  return_rows=)`, and `paged.paged_decode_loop` over bf16, f32, int8 and
  int4 pools (a block crossing a page boundary), with logprobs and the mu
  trajectory;
- the graph path's host side, with a stand-in capture whose replay re-runs
  the captured step's closure on the same buffers: one graph per static
  key serves blocks with other values, masks, positions and tables, and
  the graphs a cache keeps stay bounded.

Tolerances: logits, logprobs and f32 cache rows within atol = rtol = 1e-5
(f32 on both sides, sums in another order; as test_torch_decode_loop.py).
bf16 rows within one bf16 rounding (2^-7 relative: a value within f32
noise of a rounding boundary may round the other way). int8 and int4
codes: at most one code off at a rounding tie (test_torch_serve.py), on
at most 1% of the rows, scales within 1e-5. Mirostat's mu within atol
1e-5. Tokens equal: the sampled runs are handed the uniforms the
reference draws from its key (a split per step, `uniform(sub, (B, V),
1e-20, 1.0)`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu import paged as jpaged
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops import sampling as js
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import paged as tpaged
from llm_tpu_torch.ops import sampling as ts

CTX, V, PAGE = 64, 96, 16
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-7)
MU_TOL = dict(rtol=0, atol=1e-5)
DENSE = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16), "int8": ("int8", "int8")}
POOLS = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16), "int8": ("int8", "int8"),
         "int4": ("int4", "int4")}
MASK = [True, False, True]
BAN = ((0, float("-inf")),)  # the tiny vocab's EoT


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_multi_step") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jm = j_load(path, "llama", params=JModelParameters(context_size=CTX))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    return jm, tm


def _ref_uniforms(key, n_steps, B):
    """The uniforms the reference's batched loops draw from `key`."""
    us = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(sub, (B, V), minval=1e-20,
                                                maxval=1.0)))
    return torch.from_numpy(np.stack(us))


def _assert_rows(got, ref, kind):
    """Cache or pool tensors of one kind against the reference's."""
    got = got.to(torch.float32).numpy() if got.dtype == torch.bfloat16 \
        else got.numpy()
    ref = np.asarray(ref.astype(jnp.float32) if ref.dtype == jnp.bfloat16
                     else ref)
    if kind == "codes":
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    else:
        np.testing.assert_allclose(got, ref, **(BF16_TOL if kind == "bf16"
                                                else TOL))


def _assert_cache(tc, jc, kv):
    names = ("k", "v", "k_scale", "v_scale")
    for name in names:
        t, j = getattr(tc, name), getattr(jc, name)
        if t is None:
            assert j is None
            continue
        kind = ("codes" if kv in ("int8", "int4") and name in "kv"
                else "bf16" if kv == "bf16" else "f32")
        if kv == "int4" and name in "kv":  # compare the unpacked codes
            from llm_tpu_torch.ops.packing import unpack_int4_rows

            t = unpack_int4_rows(t).to(torch.int8)
            j = jnp.asarray(unpack_int4_rows(torch.from_numpy(
                np.array(j))).numpy().astype(np.int8))
        _assert_rows(t, j, kind)


# -- the dense cache --------------------------------------------------------


def _dense_setup(models, kv):
    """3 streams in both caches: 8 prompt tokens each, then 4 more for
    streams 0 and 2 (stream 1's write masked). Returns the caches, the
    last logits of each stream (port's and reference's) and n_past."""
    jm, tm = models
    jdt, tdt = DENSE[kv]
    rng = np.random.default_rng(2)
    ids = rng.integers(1, V, (3, 8)).astype(np.int32)
    ids2 = rng.integers(1, V, (3, 4)).astype(np.int32)
    jc = jfwd.init_cache_batched(jm.spec, 3, jdt)
    tc = tfwd.init_cache_batched(tm.spec, 3, tdt)
    jl, _, jc = jfwd.forward_batched_step(jm.spec, jm.params,
                                          jnp.asarray(ids),
                                          jnp.zeros(3, jnp.int32), jc, CTX)
    tl, _, _ = tfwd.forward_batched(tm.spec, tm.params,
                                    torch.from_numpy(ids).long(), [0] * 3,
                                    tc, CTX)
    jl2, _, jc = jfwd.forward_batched_step(
        jm.spec, jm.params, jnp.asarray(ids2), jnp.full(3, 8, jnp.int32), jc,
        CTX, jnp.asarray(MASK))
    tl2, _, _ = tfwd.forward_batched(tm.spec, tm.params,
                                     torch.from_numpy(ids2).long(), [8] * 3,
                                     tc, CTX, MASK)
    jlast = np.asarray(jl2[:, -1]).copy()
    jlast[1] = np.asarray(jl[1, -1])
    tlast = tl2[:, -1].clone()
    tlast[1] = tl[1, -1]
    np.testing.assert_allclose(tlast.numpy(), jlast,
                               **(TOL if kv != "bf16" else BF16_TOL))
    return jc, tc, jlast, tlast, np.array([12, 8, 12], np.int32)


@pytest.mark.parametrize("n_past", [[0, 3], [60, 62]])
def test_write_cache_mask_on_device(models, n_past):
    """A device bool mask: the masked stream's rows stay as they were, the
    others land at their (clamped) positions, as with host bools."""
    spec = models[1].spec
    L, T = spec.n_layer, 3
    rng = np.random.default_rng(5)
    caches = []
    for mask in ([True, False, True], torch.tensor([True, False, True])):
        cache = tfwd.init_cache_batched(spec, 3, "int8")
        for t in (cache.k, cache.v):
            t.copy_(torch.from_numpy(rng.integers(-9, 9, t.shape)
                                     .astype(np.int8)))
        before = cache.k.clone()
        news = [(torch.from_numpy(rng.integers(-127, 128, (3, T, 4, 16))
                                  .astype(np.int8)),
                 torch.from_numpy(rng.uniform(0, 1, (3, T, 4))
                                  .astype(np.float32)))
                for _ in range(2 * L)]
        npast = torch.tensor(n_past + [5], dtype=torch.int32)
        tfwd.write_cache_batched(cache, news[:L], news[L:], npast, mask)
        assert torch.equal(cache.k[:, 1], before[:, 1])
        for b in (0, 2):
            start = min(max(int(npast[b]), 0), CTX - T)
            for l in range(L):
                assert torch.equal(cache.k[l, b, :, start:start + T],
                                   news[l][0][b].transpose(0, 1))
        caches.append(cache)
        rng = np.random.default_rng(5)  # the same rows for the tensor mask
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(caches[0], name), getattr(caches[1], name))


@pytest.mark.parametrize("kv", list(DENSE))
def test_decode_loop_batched_greedy_masked_slot(models, kv):
    jm, tm = models
    jc, tc, jlast, tlast, n_past = _dense_setup(models, kv)
    slot1 = [t.clone() for t in (tc.k[:, 1], tc.v[:, 1])]
    jt, jlog, jn, jc = jfwd.decode_loop_batched(
        jm.spec, jm.params, jnp.asarray(jlast), jnp.asarray(n_past), jc, 6,
        CTX, write_mask=jnp.asarray(MASK))
    tt, tlog, tn, tc2 = tfwd.decode_loop_batched(
        tm.spec, tm.params, tlast, n_past, tc, 6, CTX, write_mask=MASK)
    assert tc2 is tc and tt.shape == (6, 3) and tt.dtype == torch.int32
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tn.tolist() == np.asarray(jn).tolist() == [18, 14, 18]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               **(TOL if kv != "bf16" else BF16_TOL))
    _assert_cache(tc, jc, kv)
    assert torch.equal(tc.k[:, 1], slot1[0])  # the masked slot's rows
    assert torch.equal(tc.v[:, 1], slot1[1])


MIX = [dict(kind="sample", temperature=0.9, mirostat=2, mirostat_tau=3.0,
            repeat_penalty=1.2),
       dict(kind="sample", temperature=0.7, top_k=12, top_p=0.9,
            frequency_penalty=0.3, bias=((5, 2.0),)),
       dict(repeat_penalty=1.4, bias=BAN)]


def _mix_inputs(n_past_hist):
    """Both sides' batched sampler, values and state (penalties over each
    stream's history, mirostat mu) for MIX."""
    jcfg, jv = js.batched_sampler([js.DeviceSampler(**k) for k in MIX], 3)
    tcfg, tv = ts.batched_sampler([ts.DeviceSampler(**k) for k in MIX], 3)
    mu = np.array([6.0, 0.0, 0.0], np.float32)
    jst = dict(js.penalty_state(n_past_hist, jcfg.penalty_last_n, V),
               mu=jnp.asarray(mu))
    tst = dict(ts.penalty_state(n_past_hist, tcfg.penalty_last_n, V),
               mu=torch.from_numpy(mu))
    return (jcfg, jv, jst), (tcfg, tv, tst)


def _assert_extras(tout, jout, n_steps):
    """The sampler state, the mu trajectory and the logprob arrays."""
    tst, (tlp, ttv, tti) = tout[4], tout[5]
    jst, (jlp, jtv, jti) = jout[4], jout[5]
    assert set(tst) == set(jst) == {"counts", "ring", "pos", "mu",
                                    "mu_steps"}
    for k in ("counts", "ring", "pos"):
        assert np.array_equal(tst[k].numpy(), np.asarray(jst[k])), k
    assert tst["mu_steps"].shape == (n_steps, 3)
    np.testing.assert_allclose(tst["mu_steps"].numpy(),
                               np.asarray(jst["mu_steps"]), **MU_TOL)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(ttv.numpy(), np.asarray(jtv), **TOL)
    assert tti.numpy().tolist() == np.asarray(jti).tolist()


def test_decode_loop_batched_sampled_matches_reference(models):
    jm, tm = models
    jc, tc, jlast, tlast, n_past = _dense_setup(models, "f32")
    hist = [[1, 2, 3, 2], [7, 7, 9], [4]]
    (jcfg, jv, jst), (tcfg, tv, tst) = _mix_inputs(hist)
    key = jax.random.PRNGKey(8)
    jout = jfwd.decode_loop_batched(
        jm.spec, jm.params, jnp.asarray(jlast), jnp.asarray(n_past), jc, 5,
        CTX, jcfg, key, jv, jnp.asarray(MASK), jst, 3, True)
    tout = tfwd.decode_loop_batched(
        tm.spec, tm.params, tlast, n_past, tc, 5, CTX, tcfg,
        sampler_values=tv, write_mask=MASK, penalty_state=tst, logprobs_n=3,
        return_state=True, uniforms=_ref_uniforms(key, 5, 3))
    assert tout[0].tolist() == np.asarray(jout[0]).tolist()
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **TOL)
    _assert_extras(tout, jout, 5)
    parts = tfwd.unpack_decode_out(tout, True, 3)
    assert parts[4] is tout[4] and parts[5] is tout[5]


def test_decode_loop_batched_checks_uniforms(models):
    _, tm = models
    cache = tfwd.init_cache_batched(tm.spec, 2, torch.float32)
    with pytest.raises(ValueError, match="uniforms"):
        tfwd.decode_loop_batched(
            tm.spec, tm.params, np.zeros((2, V), np.float32), [0, 0], cache,
            4, CTX, ts.DeviceSampler.top_k_temperature(),
            uniforms=torch.full((4, 3, V), 0.5))
    with pytest.raises(ValueError, match="does not cover"):
        tfwd.decode_loop_batched(tm.spec, tm.params,
                                 np.zeros((2, V), np.float32), [60, 1],
                                 cache, 8, CTX)


# -- the page pool ----------------------------------------------------------


def _tables():
    """Stream b owns pages 1 + 4b .. 4 + 4b (4 pages of 16: the context)."""
    return np.arange(1, 13, dtype=np.int32).reshape(3, 4)


def _paged_setup(models, kv):
    """3 streams in both pools: 8 prompt tokens each, then 12 more for
    stream 0 and 6 for stream 2 (n_past 20, 8, 14: stream 2's block
    crosses the page boundary at 16)."""
    jm, tm = models
    jdt, tdt = POOLS[kv]
    tables = _tables()
    jpool = jpaged.init_paged_cache(jm.spec, 13, PAGE, jdt)
    tpool = tpaged.init_paged_cache(tm.spec, 13, PAGE, tdt)
    rng = np.random.default_rng(3)
    last_j, last_t = [None] * 3, [None] * 3
    for rows, T, start in (([0, 1, 2], 8, 0), ([0], 12, 8), ([2], 6, 8)):
        ids = rng.integers(1, V, (len(rows), T)).astype(np.int32)
        npast = np.full(len(rows), start, np.int32)
        wp = -(-(start + T) // PAGE)
        jl, _, jpool = jpaged.paged_step(
            jm.spec, jm.params, jnp.asarray(ids), jnp.asarray(npast),
            jnp.asarray(tables[rows]), jpool, wp)
        tl, _, _ = tpaged.paged_forward_batched(
            tm.spec, tm.params, torch.from_numpy(ids).long(),
            torch.from_numpy(npast), torch.from_numpy(tables[rows]), tpool,
            wp)
        for i, b in enumerate(rows):
            last_j[b] = np.asarray(jl[i, -1])
            last_t[b] = tl[i, -1]
    tlast = torch.stack(last_t)
    jlast = np.stack(last_j)
    np.testing.assert_allclose(tlast.numpy(), jlast,
                               **(TOL if kv != "bf16" else BF16_TOL))
    return jpool, tpool, jlast, tlast, np.array([20, 8, 14], np.int32), \
        tables


def test_fold_block_rows_matches_reference(models):
    spec = models[1].spec
    rng = np.random.default_rng(7)
    B, Sp, L, H, D = 3, 5, spec.n_layer, spec.n_head_kv, spec.head_dim
    codes = [rng.integers(-127, 128, (Sp, L, B, H, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.001, 0.02, (Sp, L, B, H)).astype(np.float32)
              for _ in range(2)]
    qf = rng.standard_normal((B, 1, H, 1, D)).astype(np.float32)
    m = rng.standard_normal((B, 1, H, 1)).astype(np.float32)
    l = rng.uniform(0.5, 2, (B, 1, H, 1)).astype(np.float32)
    acc = rng.standard_normal((B, 1, H, 1, D)).astype(np.float32)
    base = np.array([4, 9, 0], np.int32)
    n_past = np.array([7, 9, 5], np.int32)  # stream 1: no block row yet
    slopes = np.linspace(0.1, 0.5, H).astype(np.float32).reshape(H, 1)
    for sl in (None, slopes):
        ref = jpaged._fold_block_rows(
            spec, *(jnp.asarray(a) for a in codes + scales),
            jnp.asarray(base), jnp.asarray(n_past), 1,
            None if sl is None else jnp.asarray(sl), jnp.asarray(qf),
            jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc))
        got = tpaged._fold_block_rows(
            spec, *(torch.from_numpy(a) for a in codes + scales),
            torch.from_numpy(base), torch.from_numpy(n_past), 1,
            None if sl is None else torch.from_numpy(sl),
            torch.from_numpy(qf), torch.from_numpy(m), torch.from_numpy(l),
            torch.from_numpy(acc))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
        # a stream without block rows keeps its pool pass's state
        assert np.array_equal(got[0][1].numpy(), m[1])


def test_paged_forward_block_rows_matches_reference(models):
    """One block-buffered step: the pool masked at the block's base, two
    rows of the block folded in, the new rows returned and the pool left
    as it was."""
    jm, tm = models
    jpool, tpool, jlast, tlast, n_past, tables = _paged_setup(models, "int8")
    rng = np.random.default_rng(9)
    L, H, D = tm.spec.n_layer, tm.spec.n_head_kv, tm.spec.head_dim
    blk = [rng.integers(-127, 128, (4, L, 3, H, D)).astype(np.int8)
           for _ in range(2)]
    blk += [rng.uniform(0.001, 0.05, (4, L, 3, H)).astype(np.float32)
            for _ in range(2)]
    base = n_past - 2
    ids = rng.integers(1, V, (3, 1)).astype(np.int32)
    jl, _, (jk, jv) = jpaged.paged_forward_batched(
        jm.spec, jm.params, jnp.asarray(ids), jnp.asarray(n_past),
        jnp.asarray(tables), jpool, 2,
        block_kv=tuple(jnp.asarray(a) for a in blk) + (jnp.asarray(base),),
        return_rows=True)
    before = tpool.k.clone()
    tl, _, (tk, tv) = tpaged.paged_forward_batched(
        tm.spec, tm.params, torch.from_numpy(ids).long(),
        torch.from_numpy(n_past), torch.from_numpy(tables), tpool, 2,
        block_kv=tuple(torch.from_numpy(a) for a in blk)
        + (torch.from_numpy(base),), return_rows=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (tq, ts_), (jq, js_) in ((tk, jk), (tv, jv)):
        assert tq.shape == (L, 3, 1, H, D)
        _assert_rows(tq, jq, "codes")
        np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), **TOL)
    assert torch.equal(tpool.k, before)


@pytest.mark.parametrize("kv", list(POOLS))
def test_paged_decode_loop_greedy_matches_reference(models, kv):
    jm, tm = models
    jpool, tpool, jlast, tlast, n_past, tables = _paged_setup(models, kv)
    jt, jlog, jn, jpool = jpaged.paged_decode_loop(
        jm.spec, jm.params, jnp.asarray(jlast), jnp.asarray(n_past),
        jnp.asarray(tables), jpool, 6, 2)
    tt, tlog, tn, tpool2 = tpaged.paged_decode_loop(
        tm.spec, tm.params, tlast, n_past, tables, tpool, 6, 2)
    assert tpool2 is tpool and tt.shape == (6, 3)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tn.tolist() == np.asarray(jn).tolist() == [26, 14, 20]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               **(TOL if kv != "bf16" else BF16_TOL))
    _assert_cache(tpool, jpool, kv)


def test_paged_decode_loop_sampled_matches_reference(models):
    """int8 pool, MIX: per-stream values, penalties, mirostat 2's mu
    trajectory and logprobs, the reference's uniforms."""
    jm, tm = models
    jpool, tpool, jlast, tlast, n_past, tables = _paged_setup(models, "int8")
    (jcfg, jv, jst), (tcfg, tv, tst) = _mix_inputs([[1, 2, 3], [], [4, 4]])
    key = jax.random.PRNGKey(4)
    jout = jpaged.paged_decode_loop(
        jm.spec, jm.params, jnp.asarray(jlast), jnp.asarray(n_past),
        jnp.asarray(tables), jpool, 6, 2, jcfg, key, jv, True, jst, 2, True)
    tout = tpaged.paged_decode_loop(
        tm.spec, tm.params, tlast, n_past, tables, tpool, 6, 2, tcfg,
        sampler_values=tv, penalty_state=tst, logprobs_n=2,
        return_state=True, uniforms=_ref_uniforms(key, 6, 3))
    assert tout[0].tolist() == np.asarray(jout[0]).tolist()
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), **TOL)
    _assert_extras(tout, jout, 6)
    _assert_cache(tpool, jout[3], "int8")


# -- the graph path's host side ----------------------------------------------


class _Replay:
    """Stand-in for a captured graph: a replay re-runs the captured step's
    closure on the buffers it captured, as a CUDA graph replays its
    kernels on theirs, so whatever a block changes must reach the step
    through the buffers."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.fixture
def fake_graphs(monkeypatch):
    captured = []

    def capture(g, dev, step):
        g.graph = _Replay(step)
        captured.append(g)

    monkeypatch.setattr(tfwd, "_capture", capture)
    monkeypatch.setattr(tfwd, "_on_card", lambda graph, dev: graph)
    monkeypatch.setattr(tpaged, "_on_card", lambda graph, dev: graph)
    return captured


def _value_sets():
    """Two per-stream value sets of one static structure."""
    a = [ts.DeviceSampler(kind="sample", temperature=0.8, top_k=10,
                          repeat_penalty=1.2, bias=BAN),
         ts.DeviceSampler(bias=BAN),
         ts.DeviceSampler(kind="sample", temperature=1.3, top_k=3,
                          bias=((0, float("-inf")), (4, 1.0)))]
    b = [ts.DeviceSampler(kind="sample", temperature=1.7, top_k=5,
                          repeat_penalty=1.5, bias=((4, 3.0),)),
         ts.DeviceSampler(kind="sample", temperature=0.4, top_k=10,
                          bias=BAN),
         ts.DeviceSampler(repeat_penalty=1.1, bias=BAN)]
    (ca, va), (cb, vb) = (ts.batched_sampler(x, 3) for x in (a, b))
    assert ca == cb and hash(ca) == hash(cb)
    return (ca, va), (cb, vb)


def _block_inputs(seed, values):
    rng = np.random.default_rng(seed)
    cfg = values[0]
    hist = [rng.integers(1, V, 5).tolist() for _ in range(3)]
    return dict(sampler=cfg, sampler_values=values[1],
                penalty_state=ts.penalty_state(hist, cfg.penalty_last_n, V),
                uniforms=torch.rand((4, 3, V), generator=torch.Generator()
                                    .manual_seed(seed)).clamp_min_(1e-20))


def test_dense_graph_serves_other_values(models, fake_graphs):
    """Two blocks with other values, penalty state, mask, positions and
    logits replay the first block's step and give what an eager run of
    each block gives."""
    _, tm = models
    spec, params = tm.spec, tm.params
    graph_cache = tfwd.init_cache_batched(spec, 3, torch.float32)
    blocks = [(_value_sets()[0], [True, False, True], [5, 0, 9]),
              (_value_sets()[1], [False, True, True], [10, 3, 14])]
    for n, (values, mask, n_past) in enumerate(blocks):
        eager_cache = tfwd.init_cache_batched(spec, 3, torch.float32)
        eager_cache.k.copy_(graph_cache.k)
        eager_cache.v.copy_(graph_cache.v)
        logits = torch.randn(3, V, generator=torch.Generator().manual_seed(n))
        kw = dict(_block_inputs(n, values), write_mask=mask,
                  return_state=True)
        got = tfwd.decode_loop_batched(spec, params, logits, n_past,
                                       graph_cache, 4, CTX, **kw)
        want = tfwd.decode_loop_batched(spec, params, logits, n_past,
                                        eager_cache, 4, CTX, graph=False,
                                        **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for k in ("counts", "ring", "pos"):
            assert torch.equal(got[4][k], want[4][k])
        assert torch.equal(graph_cache.k, eager_cache.k)
    assert len(fake_graphs) == 1 and len(graph_cache.graphs) == 1
    (g,) = graph_cache.graphs.values()
    assert g.replays == 8 and g.state["u"].shape == (4, 3, V)


def test_paged_graph_serves_other_values(models, fake_graphs):
    """The paged step likewise, with other tables and base positions; the
    block buffer of a capacity reused by a shorter block."""
    _, tm = models
    spec, params = tm.spec, tm.params
    pool = tpaged.init_paged_cache(spec, 13, PAGE, "int8")
    eager = tpaged.init_paged_cache(spec, 13, PAGE, "int8")
    tables = _tables()
    blocks = [(_value_sets()[0], tables, [5, 0, 9], 4),
              (_value_sets()[1], tables[::-1].copy(), [17, 2, 30], 3)]
    for n, (values, tbl, n_past, steps) in enumerate(blocks):
        logits = torch.randn(3, V, generator=torch.Generator().manual_seed(n))
        kw = _block_inputs(n, values)
        kw["uniforms"] = kw["uniforms"][:steps]
        got = tpaged.paged_decode_loop(spec, params, logits, n_past, tbl,
                                       pool, steps, 2, **kw)
        want = tpaged.paged_decode_loop(spec, params, logits, n_past, tbl,
                                        eager, steps, 2, graph=False, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(pool, name), getattr(eager, name))
    assert len(fake_graphs) == 1 and len(pool.graphs) == 1
    assert next(iter(pool.graphs.values())).replays == 7


def test_graphs_keyed_and_bounded(models):
    """One entry per static key (the loop, window, B, structure, shapes,
    mu, logprobs, capacity); value sets of one structure share it; past
    the bound the least recently used entry goes."""
    _, tm = models
    spec, params = tm.spec, tm.params
    graphs = {}
    (cfg, va), (_, vb) = _value_sets()

    def entry(key, values=va, steps=4, lpn=None):
        return tfwd.batched_graph(graphs, key, spec, params, 3, cfg, values,
                                  None, False, lpn, steps, "cpu", True,
                                  lambda st: None)

    g = entry(("dense", 64))
    assert entry(("dense", 64), vb) is g  # other values, one graph
    assert entry(("dense", 64), steps=3) is g  # the same capacity
    others = [entry(("dense", 32)), entry(("dense", 64), steps=8),
              entry(("dense", 64), lpn=2), entry(("paged", 2, 4))]
    assert len({id(x) for x in [g, *others]}) == 5
    assert g.state["v_temperature"].shape == (3,) and g.bias is None
    for w in range(tfwd._MAX_GRAPHS):
        entry(("dense", 100 + w))
    assert len(graphs) == tfwd._MAX_GRAPHS
    assert not {id(x) for x in graphs.values()} & \
        {id(x) for x in [g, *others]}
