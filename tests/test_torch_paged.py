"""The port's paged KV cache and paged engine (llm_tpu_torch.paged) against
the JAX package's (llm_tpu.paged), on a tiny LLaMA Q4_0 checkpoint:

- int4 row packing, `scatter_rows` (rows past the table go to the trash
  page) and the prefix cache's digests are bit-equal;
- the in-flight rows of an int4 pool round at qmax 7, as the reference's do;
- `PagedEngine` gives the same greedy tokens and text as the reference's,
  with the logits of every step within atol = rtol = 1e-5, for f32, int8
  and int4 pools, a pool smaller than the worst case, page-boundary
  crossing, the near-context-boundary regression and prefix-cache exact
  hits and copy-on-write tails.

Tolerance: both packages run f32 on the CPU; the sums run in another order
(torch vs XLA), which moves logits of magnitude ~0.2 by a few 1e-8: atol =
rtol = 1e-5, for the quantized pools too (no code of these inputs sits at
a rounding tie; see test_torch_serve.py for one that does)."""

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
from llm_tpu.ops.packing import pack_int4_rows as j_pack
from llm_tpu.ops.packing import unpack_int4_rows as j_unpack
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.serve import GenerationRequest as JRequest
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import paged as tpaged
from llm_tpu_torch.ops.packing import pack_int4_rows, unpack_int4_rows
from llm_tpu_torch.samplers import build_sampler_chain as t_chain
from llm_tpu_torch.serve import GenerationRequest as TRequest

CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
KV = {"f32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
      "int4": ("int4", "int4")}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_paged") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jm = j_load(path, "llama", params=JModelParameters(context_size=CTX))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    return jm, tm


# one side of each comparison: (engine class, request class, chain builder)
JAX = (jpaged.PagedEngine, JRequest, j_chain)
TORCH = (tpaged.PagedEngine, TRequest, t_chain)


def _greedy(side):
    _, _, chain = side
    return chain(["topk:k=1"], bias=[(0, float("-inf"))])  # EoT banned


def _drive(engine, ids):
    """Step to completion. Returns (tokens, text, rows) of each id, rows the
    logits each generated token was sampled from, copied after every step.
    The row a stream's retiring step computes is left out: the reference
    engine on the CPU builds that step's page tables zero-copy from the
    host array its retirement then clears, so its last row may be read
    through the trash page (on its TPU the tables are copied at dispatch;
    the port copies them too)."""
    rows = {i: [] for i in ids}
    while engine.has_work():
        engine.step()
        for s in engine.slots:
            if s is not None and s.request_id in rows and not s.prefilling:
                rows[s.request_id].append(np.array(s.last_logits,
                                                   np.float32))
    return [(engine.finished[i].tokens, "".join(engine.finished[i].text),
             np.stack(rows[i]) if rows[i] else None) for i in ids]


def _run(side, engine, prompts, n):
    """Run `prompts` to completion; (tokens, text, last_logits) each."""
    _, request, _ = side
    ids = [engine.submit(request(prompt=p, max_tokens=n,
                                 sampler=_greedy(side))) for p in prompts]
    return _drive(engine, ids)


def _assert_same(got, ref, tol=TOL):
    assert len(got) == len(ref)
    for (gt, gx, gl), (rt, rx, rl) in zip(got, ref):
        assert gt == rt
        assert gx == rx and gx
        if rl is None:  # retired in the step that finished its prefill
            assert gl is None
        else:
            np.testing.assert_allclose(gl, rl, **tol)


def _engines(models, kv, **kw):
    jm, tm = models
    return (jpaged.PagedEngine(jm, kv_dtype=KV[kv][0], **kw),
            tpaged.PagedEngine(tm, kv_dtype=KV[kv][1], **kw))


PROMPTS = [[2, 3], [9, 4, 5] * 7, [7] * 30]


# -- bit-equal pieces --------------------------------------------------------


def test_pack_unpack_int4_bit_equal():
    rng = np.random.default_rng(0)
    codes = rng.integers(-7, 8, size=(3, 5, 16)).astype(np.int8)
    packed = pack_int4_rows(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 8)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_pack(jnp.asarray(codes))))
    np.testing.assert_array_equal(unpack_int4_rows(packed).numpy(), codes)
    raw = rng.integers(0, 256, size=(4, 64)).astype(np.uint8)  # every byte
    np.testing.assert_array_equal(unpack_int4_rows(torch.from_numpy(raw)),
                                  np.asarray(j_unpack(jnp.asarray(raw))))


@pytest.mark.parametrize("kv", list(KV))
def test_scatter_rows_bit_equal(kv):
    """Rows land in their page slots; positions past the table land on
    the trash page (never on the stream's last live page)."""
    rng = np.random.default_rng(1)
    Lr, npg, hkv, page, d, P = 2, 6, 2, 4, 8, 2
    pool = {
        "f32": lambda: tpaged.init_paged_cache(
            _spec(Lr, hkv, d), npg, page, torch.float32),
        "int8": lambda: tpaged.init_paged_cache(_spec(Lr, hkv, d), npg, page,
                                                "int8"),
        "int4": lambda: tpaged.init_paged_cache(_spec(Lr, hkv, d), npg, page,
                                                "int4"),
    }[kv]()
    for t in (pool.k, pool.v, pool.k_scale, pool.v_scale):
        if t is not None:
            t.copy_(torch.from_numpy(
                rng.integers(0, 100, size=t.shape).astype(
                    t.numpy().dtype)))
    tables = np.array([[3, 5], [1, 0]], np.int32)
    # stream 0: in its pages; stream 1: its second entry is the trash page
    # and positions 8, 9 are past its 2-page table
    positions = np.array([[2, 3, 4], [5, 8, 9]], np.int32)
    shape = (Lr, 2, 3, hkv, d)
    if kv == "f32":
        k_new = rng.standard_normal(shape).astype(np.float32)
        v_new = rng.standard_normal(shape).astype(np.float32)
        t_k, t_v = torch.from_numpy(k_new), torch.from_numpy(v_new)
        j_k, j_v = jnp.asarray(k_new), jnp.asarray(v_new)
    else:
        qmax = 7 if kv == "int4" else 127
        news = [(rng.integers(-qmax, qmax + 1, size=shape).astype(np.int8),
                 rng.uniform(0.01, 1, size=shape[:-1]).astype(np.float32))
                for _ in range(2)]
        t_k, t_v = [tuple(torch.from_numpy(a) for a in n) for n in news]
        j_k, j_v = [tuple(jnp.asarray(a) for a in n) for n in news]
    jpool = jpaged.PagedKVCache(*(None if t is None else jnp.asarray(t.numpy())
                                  for t in (pool.k, pool.v, pool.k_scale,
                                            pool.v_scale)))
    jout = jpaged.scatter_rows(jpool, j_k, j_v, jnp.asarray(positions),
                               jnp.asarray(tables))
    before = pool.k.clone()
    tpaged.scatter_rows(pool, t_k, t_v, torch.from_numpy(positions),
                        torch.from_numpy(tables))
    for name in ("k", "v", "k_scale", "v_scale"):
        t, j = getattr(pool, name), getattr(jout, name)
        if t is None:
            assert j is None
            continue
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    # stream 1's last live page (1) keeps everything past offset 1
    assert torch.equal(pool.k[:, 1, :, 2:], before[:, 1, :, 2:])
    assert not torch.equal(pool.k[:, 0], before[:, 0])  # trash page hit


def _spec(n_layer, hkv, d):
    from types import SimpleNamespace

    return SimpleNamespace(n_layer=n_layer, n_head_kv=hkv, head_dim=d)


def test_prefix_cache_digests_equal():
    toks = list(np.random.default_rng(2).integers(1, 96, 53))
    assert tpaged.PrefixCache.digests(toks, 8, 6) == \
        jpaged.PrefixCache.digests(toks, 8, 6)
    assert len(tpaged.PrefixCache.digests(toks, 8, 6)) == 6


def test_page_allocator():
    a = tpaged.PageAllocator(5)
    assert a.available == 4  # page 0 reserved
    pages = a.alloc(4)
    assert tpaged.PageAllocator.TRASH not in pages
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.release(pages + [0])
    assert a.available == 4


def test_int4_inflight_rows_round_at_qmax_7(models):
    """`_attention_batched(qmax=7.0)`: the rows a step writes to an
    int4 pool, and the scores it computes from them, equal the
    reference's."""
    jm, tm = models
    spec = tm.spec
    rng = np.random.default_rng(3)
    B, T = 2, 5
    a = rng.standard_normal((B, T, spec.n_embd)).astype(np.float32)
    n_past = np.array([0, 7], np.int32)
    positions = n_past[:, None] + np.arange(T, dtype=np.int32)[None, :]
    Hkv, rep, D = spec.n_head_kv, spec.n_head // spec.n_head_kv, spec.head_dim

    def empty(qf, xp, full, zeros):  # no cached keys: the chunk's own only
        shape = (B, T, Hkv, rep)
        return full(shape, -1e30), zeros(shape), zeros(shape + (D,))

    # the reference takes True for its int8 range
    for qmax, j_quantize in ((7.0, 7.0), (127.0, True)):
        got, k_out, v_out = tfwd._attention_batched(
            spec, tm.params.layers.layer(0), torch.from_numpy(a),
            torch.from_numpy(positions), torch.from_numpy(n_past),
            (None, None), (None, None),
            online_pass=lambda qf: empty(qf, torch, torch.full, torch.zeros),
            qmax=qmax)
        ref, jk_out, jv_out = jfwd._attention_batched(
            jm.spec, jfwd._LayerView(jm.params.layers, 0), jnp.asarray(a),
            jnp.asarray(positions), jnp.asarray(n_past), (None, None),
            (None, None),
            online_pass=lambda qf: empty(qf, jnp, jnp.full, jnp.zeros),
            quantize_kv=j_quantize)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        for t, j in ((k_out, jk_out), (v_out, jv_out)):
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
            np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), **TOL)
        assert int(k_out[0].abs().max()) == qmax


# -- engine against engine --------------------------------------------------


@pytest.mark.parametrize("kv", list(KV))
def test_engine_matches_reference(models, kv):
    je, te = _engines(models, kv, max_streams=3, page_size=16, n_batch=8)
    _assert_same(_run(TORCH, te, PROMPTS, 10), _run(JAX, je, PROMPTS, 10))


def test_engine_pool_smaller_than_worst_case(models):
    """More requests than the pool holds at once: admission defers and
    pages are recycled across streams."""
    prompts = [[i, i + 1] for i in range(2, 10)]
    # 4 pages a stream worst case, 8 streams -> 32 pages; give 9
    je, te = _engines(models, "f32", max_streams=4, page_size=16, n_pages=9,
                      n_batch=8)
    _assert_same(_run(TORCH, te, prompts, 6), _run(JAX, je, prompts, 6))
    assert te.allocator.available == 8  # every page back in the pool


def test_engine_page_boundary_crossing(models):
    je, te = _engines(models, "int8", max_streams=1, page_size=16, n_batch=8)
    _assert_same(_run(TORCH, te, [[2, 3]], 40), _run(JAX, je, [[2, 3]], 40))


def _near_boundary(side, engine):
    """tests/test_paged.py's regression: while stream A sits near full
    context, admitting B must not corrupt A's live pages."""
    _, request, _ = side
    a = engine.submit(request(prompt=[2] * 40, max_tokens=18,
                              sampler=_greedy(side)))
    for _ in range(14):
        engine.step()
    assert engine.slots[0] is not None and engine.slots[0].n_past >= 50
    b = engine.submit(request(prompt=[5, 6, 7], max_tokens=4,
                              sampler=_greedy(side)))
    return _drive(engine, [a, b])


def test_engine_prefill_near_context_boundary(models):
    je, te = _engines(models, "f32", max_streams=2, page_size=16, n_batch=8)
    got = _near_boundary(TORCH, te)
    _assert_same(got, _near_boundary(JAX, je))
    # A's continuation equals an uninterrupted run
    alone = _run(TORCH, _engines(models, "f32", max_streams=1, page_size=16,
                                 n_batch=8)[1], [[2] * 40], 18)
    assert got[0][0] == alone[0][0]


def _count_prefill_chunks(engine):
    calls = []
    orig = engine._prefill_chunk

    def counting(stream, slot):
        calls.append(stream.prefill_pos)
        return orig(stream, slot)

    engine._prefill_chunk = counting
    return calls


def _prefix_sequence(side, engine, prompt):
    """Cold run, exact hit (no prefill at all), then copy-on-write (the
    logits row evicted: only the last prompt token is re-evaluated)."""
    cold = _run(side, engine, [prompt], 6)
    calls = _count_prefill_chunks(engine)
    exact = _run(side, engine, [prompt], 6)
    exact_calls = list(calls)
    engine.prefix_cache.logits_by_key.clear()
    calls.clear()
    cow = _run(side, engine, [prompt], 6)
    cache = engine.prefix_cache
    assert all(v == 0 for v in cache.refs.values())  # no reference leaked
    return cold + exact + cow, exact_calls, list(calls)


@pytest.mark.parametrize("kv", ["f32", "int4"])
def test_prefix_cache_exact_hit_and_cow(models, kv):
    prompt = list(range(2, 18))  # 16 tokens: exactly 2 pages of 8
    je, te = _engines(models, kv, max_streams=2, page_size=8, n_batch=8,
                      prefix_cache=True)
    got, exact_calls, cow_calls = _prefix_sequence(TORCH, te, prompt)
    ref, *_ = _prefix_sequence(JAX, je, prompt)
    _assert_same(got, ref)
    assert got[0][0] == got[1][0] == got[2][0]  # reuse changes nothing
    assert exact_calls == [] and cow_calls == [15]
