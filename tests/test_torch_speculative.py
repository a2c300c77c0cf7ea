"""The port's speculative decoding (`llm_tpu_torch.speculative`) against the
JAX package's (`llm_tpu.speculative`), on tiny LLaMA checkpoints (context
64, V = 96): a 2-layer target (seed 0) and a mismatched 1-layer draft
(seed 7), in Q4_0 and Q8_0.

- `SpeculativeSession` at k = 1, 3, 4: the reference's tokens, acceptance
  and head logits, and plain greedy decoding's tokens; the self-draft
  accepts every proposal.
- `SampledSpeculativeSession`: given the seed, the reference's tokens and
  acceptance counts (the same numpy draws in the same order).
- `_sampling_probs` against the reference's within 1e-12 (float64), and
  the rejection step reproducing the target distribution.
- The four engines against the reference's engines: dense and paged,
  greedy and sampled (the sampled ones given the reference's uniforms),
  f32 / int8 caches and f32 / int8 / int4 pools, interleaved admission,
  the prefix cache with a borrowed prefix, a pool too tight for a round,
  the context boundary, the draft-cache repair after a fallback, and the
  submit guards.
- The card's graph path, its host side: the session and the engines run
  with a stand-in capture (each "replay" re-runs the captured closure on
  its static buffers) give the eager tokens.

Tolerances: logits within atol = rtol = 1e-5 (f32 on both sides; int8 /
int4: 5e-5, a code at a rounding tie, as test_torch_serve.py); tokens,
texts and acceptance counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import paged as jpaged
from llm_tpu import speculative as jsp
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.models.forward import forward_step as j_forward_step
from llm_tpu.models.forward import init_cache as j_init_cache
from llm_tpu.ops.sampling import DeviceSampler as JDS
from llm_tpu.serve import GenerationRequest as JReq
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import speculative as tsp
from llm_tpu_torch.models import forward as tfwd
from llm_tpu_torch.models.forward import forward_step, init_cache
from llm_tpu_torch.ops.sampling import DeviceSampler as TDS
from llm_tpu_torch.ops.sampling import device_sample
from llm_tpu_torch.paged import PagedEngine as TPagedEngine
from llm_tpu_torch.samplers import GreedySampler as TGreedy
from llm_tpu_torch.samplers import default_samplers as t_default_samplers
from llm_tpu_torch.serve import Engine as TEngine
from llm_tpu_torch.serve import GenerationRequest as TReq
from llm_tpu_torch.session import ContextFull
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

CTX, V = 64, 96
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_QUANT = dict(rtol=1e-5, atol=5e-5)
JAX, TORCH = "jax", "torch"
KV = {"f32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
      "int4": ("int4", "int4"), "bf16": (jnp.bfloat16, torch.bfloat16)}
PROMPTS = [[2, 3], [9, 4, 5], [7, 8, 2, 11]]


def _load(path):
    return (j_load(path, "llama", params=JModelParameters(context_size=CTX)),
            tloader.load(path, "llama",
                         params=tloader.ModelParameters(context_size=CTX),
                         device="cpu"))


@pytest.fixture(scope="module", params=[GgmlType.Q4_0, GgmlType.Q8_0],
                ids=["q4_0", "q8_0"])
def pair(request, tmp_path_factory):
    """{"jax": (target, draft), "torch": (target, draft)}."""
    d = tmp_path_factory.mktemp(f"torch_spec_{request.param.name}")
    make_tiny_file("llama", d / "target.bin", request.param, seed=0)
    make_tiny_file("llama", d / "draft.bin", request.param, seed=7,
                   n_layer=1)
    (jt, tt), (jd, td) = _load(d / "target.bin"), _load(d / "draft.bin")
    return {JAX: (jt, jd), TORCH: (tt, td)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The Q4_0 pair, for the engine tests."""
    d = tmp_path_factory.mktemp("torch_spec_engines")
    make_tiny_file("llama", d / "target.bin", GgmlType.Q4_0, seed=0)
    make_tiny_file("llama", d / "draft.bin", GgmlType.Q4_0, seed=7,
                   n_layer=1)
    (jt, tt), (jd, td) = _load(d / "target.bin"), _load(d / "draft.bin")
    short = tloader.load(
        d / "draft.bin", "llama",
        params=tloader.ModelParameters(context_size=CTX // 2), device="cpu")
    return {JAX: (jt, jd), TORCH: (tt, td), "short_ctx_draft": short}


@pytest.fixture(autouse=True)
def reference_step_waits(monkeypatch):
    """The reference's paged step reads its page tables as a zero-copy view
    on the CPU; waiting for its outputs gives the tables as they were at
    dispatch (test_torch_step_multi.py)."""
    step = jpaged.paged_step
    monkeypatch.setattr(
        jpaged, "paged_step",
        lambda *a, **kw: jax.block_until_ready(step(*a, **kw)))


def _plain_greedy(model, prompt, n):
    """The port's token-at-a-time greedy decoding (f32 cache)."""
    cache = init_cache(model.spec, torch.float32)
    logits, _, _ = forward_step(model.spec, model.params,
                                torch.tensor(prompt), 0, cache)
    last, n_past, out = logits[-1].numpy(), len(prompt), []
    for _ in range(n):
        tok = int(np.argmax(last))
        out.append(tok)
        if tok == model.eot_token_id():
            break
        logits, _, _ = forward_step(model.spec, model.params,
                                    torch.tensor([tok]), n_past, cache)
        last, n_past = logits[0].numpy(), n_past + 1
    return out


def _j_greedy(model, prompt, n):
    """The reference test's `_greedy_reference` (f32 cache)."""
    cache = j_init_cache(model.spec, jnp.float32)
    logits, _, cache = j_forward_step(model.spec, model.params,
                                      jnp.asarray(prompt, jnp.int32),
                                      jnp.int32(0), cache)
    last, n_past, out = np.asarray(logits)[-1], len(prompt), []
    for _ in range(n):
        tok = int(np.argmax(last))
        out.append(tok)
        if tok == model.eot_token_id():
            break
        logits, _, cache = j_forward_step(model.spec, model.params,
                                          jnp.asarray([tok], jnp.int32),
                                          jnp.int32(n_past), cache)
        last, n_past = np.asarray(logits)[0], n_past + 1
    return out


def _session(side, pair, k, self_draft=False, sampled=None):
    target, draft = pair[side]
    draft = target if self_draft else draft
    mod = jsp if side == JAX else tsp
    kv = KV["f32"][0 if side == JAX else 1]
    if sampled is not None:
        return mod.SampledSpeculativeSession(target, draft, k=k,
                                             kv_dtype=kv, **sampled)
    return mod.SpeculativeSession(target, draft, k=k, kv_dtype=kv)


# -- the sessions ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 4])
def test_session_mismatched_draft_matches_reference_and_greedy(pair, k):
    prompt = [2, 9, 4]
    got, ref = _session(TORCH, pair, k), _session(JAX, pair, k)
    got.feed_prompt(prompt)
    ref.feed_prompt(prompt)
    toks, ref_toks = got.generate(16), ref.generate(16)
    assert toks == ref_toks
    assert toks == _plain_greedy(pair[TORCH][0], prompt, 16)
    assert (got.accepted, got.drafted) == (ref.accepted, ref.drafted)
    assert got.n_past == ref.n_past and got.tokens == ref.tokens
    np.testing.assert_allclose(got.last_logits, ref.last_logits, **TOL)
    if k > 1:
        assert got.acceptance_rate < 1.0  # the draft really mismatches


def test_session_self_draft_accepts_everything(pair):
    prompt = [2, 9]
    s = _session(TORCH, pair, 4, self_draft=True)
    s.feed_prompt(prompt)
    out = s.generate(12)
    assert out == _j_greedy(pair[JAX][0], prompt, 12)
    assert s.acceptance_rate == 1.0


@pytest.mark.parametrize("self_draft,seed", [(False, 3), (False, 4),
                                             (True, 1)])
def test_sampled_session_matches_reference(pair, self_draft, seed):
    """The same seed gives the reference's tokens and acceptance counts:
    the host draws (proposals, acceptance, resampling, bonus) come from one
    numpy default_rng(seed) in the reference's order."""
    cfg = (dict(temperature=0.8) if self_draft
           else dict(temperature=0.9, top_k=20))
    got = _session(TORCH, pair, 3 + self_draft, self_draft, sampled=cfg)
    ref = _session(JAX, pair, 3 + self_draft, self_draft, sampled=cfg)
    for s in (got, ref):
        s.feed_prompt([2, 9, 4])
    toks = got.generate(12, seed=seed)
    assert toks == ref.generate(12, seed=seed)
    assert (got.accepted, got.drafted) == (ref.accepted, ref.drafted)
    np.testing.assert_allclose(got.last_logits, ref.last_logits, **TOL)
    if self_draft:  # p == q: min(1, p/q) == 1
        assert got.acceptance_rate == 1.0


def test_session_context_full(pair):
    s = _session(TORCH, pair, 4)
    with pytest.raises(ContextFull):
        s.feed_prompt([2] * CTX)


def test_session_rejects_another_vocabulary(pair, tmp_path):
    make_tiny_file("llama", tmp_path / "v.bin", GgmlType.Q4_0, n_vocab=80)
    other = tloader.load(tmp_path / "v.bin", "llama",
                         params=tloader.ModelParameters(context_size=CTX),
                         device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        tsp.SpeculativeSession(pair[TORCH][0], other)


# -- the acceptance math -----------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(temperature=0.9, top_k=25, top_p=0.8, min_p=0.05, bias=((3, 2.5),)),
    dict(temperature=0.7, top_k=1),
    dict(temperature=1.3, top_k=0, top_p=0.5),
    dict(temperature=0.5, top_k=10, min_p=0.2, bias=((0, float("-inf")),)),
])
def test_sampling_probs_matches_reference(cfg):
    """The host q equals the reference's, and its support holds every
    token the port's device sampler draws under the same config."""
    rng = np.random.default_rng(8)
    ds = TDS(kind="sample", **cfg)
    for _ in range(4):
        row = rng.normal(size=V).astype(np.float32) * 2
        got = tsp._sampling_probs(row, **cfg)
        ref = jsp._sampling_probs(row, **cfg)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got > 0, ref > 0)
        u = torch.from_numpy(rng.uniform(1e-20, 1.0, (200, V))).float()
        toks = device_sample(torch.from_numpy(row).expand(200, V), u, ds)
        assert set(toks.tolist()) <= set(np.nonzero(got > 0)[0].tolist())
    np.testing.assert_allclose(tsp._softmax64(row.astype(np.float64)),
                               jsp._softmax64(row.astype(np.float64)),
                               rtol=0, atol=1e-12)


def test_rejection_step_reproduces_target():
    """x ~ q, then the accept-or-resample step, is distributed as p."""
    rng = np.random.default_rng(0)
    p = rng.random(8)
    p /= p.sum()
    q = rng.random(8)
    q /= q.sum()
    counts = np.zeros(8)
    n = 60_000
    for _ in range(n):
        x = int(rng.choice(8, p=q))
        tok = tsp._accept_or_resample(rng, p, q, x)
        counts[x if tok is None else tok] += 1
    np.testing.assert_allclose(counts / n, p, atol=0.01)


# -- the engines -------------------------------------------------------------


def _reference_draw(monkeypatch, engine):
    """Hand the port's sampled engine the reference engine's uniforms: its
    key split once a round, then once a draft step (uniform [B, V] in
    [1e-20, 1) from each step's subkey)."""
    state = {"key": jax.random.PRNGKey(0)}

    def draw(self, n_steps, draw):
        state["key"] = jax.random.split(state["key"])[0]
        k, us = state["key"], []
        for _ in range(n_steps):
            k, sub = jax.random.split(k)
            us.append(np.asarray(jax.random.uniform(
                sub, (self.max_streams, V), minval=1e-20, maxval=1.0)))
        return torch.from_numpy(np.stack(us))

    monkeypatch.setattr(engine, "_block_uniforms",
                        draw.__get__(engine, type(engine)))


def _engine(side, models, cls_name, kv="f32", self_draft=False, **kw):
    target, draft = models[side]
    mod = jsp if side == JAX else tsp
    kw.setdefault("n_batch", 8)
    if "Paged" in cls_name:
        kw.setdefault("page_size", 16)
    return getattr(mod, cls_name)(target, target if self_draft else draft,
                                  kv_dtype=KV[kv][0 if side == JAX else 1],
                                  **kw)


def _sampled_reqs(side, seed):
    req, ds = (JReq, JDS) if side == JAX else (TReq, TDS)
    return [req(prompt=[2, 9, 4], max_tokens=10, seed=seed,
                device_sampler=ds(kind="sample", temperature=0.9, top_k=20)),
            req(prompt=[7, 8], max_tokens=10, seed=seed + 1,
                device_sampler=ds(kind="sample", temperature=0.7, top_k=8,
                                  top_p=0.9, min_p=0.02))]


def _run(engine, reqs):
    """Run to completion; per request (tokens, text, finish reason, last
    logits)."""
    ids = [engine.submit(r) for r in reqs]
    while engine.has_work():
        engine.step()
    return [(engine.finished[i].tokens, "".join(engine.finished[i].text),
             engine.finished[i].finish_reason,
             np.asarray(engine.finished[i].last_logits, np.float32))
            for i in ids]


def _greedy_reqs(side, prompts=PROMPTS, n=12):
    req = JReq if side == JAX else TReq
    return [req(prompt=p, max_tokens=n) for p in prompts]


def _assert_same(got, ref, tol=TOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[:3] == r[:3]
        np.testing.assert_allclose(g[3], r[3], **tol)


def _plain(models, kind, kv, prompts=PROMPTS, n=12, **kw):
    """The port's plain engine, greedy (GreedySampler)."""
    target = models[TORCH][0]
    if kind == "paged":
        kw.setdefault("page_size", 16)
        e = TPagedEngine(target, kv_dtype=KV[kv][1],
                         max_streams=len(prompts), **kw)
    else:
        e = TEngine(target, kv_dtype=KV[kv][1], max_streams=len(prompts),
                    n_batch=8)
    return _run(e, [TReq(prompt=p, max_tokens=n, sampler=TGreedy())
                    for p in prompts])


GREEDY_CASES = [("SpeculativeEngine", "f32"), ("SpeculativeEngine", "int8"),
                ("PagedSpeculativeEngine", "f32"),
                ("PagedSpeculativeEngine", "int8"),
                ("PagedSpeculativeEngine", "int4")]


@pytest.mark.parametrize("cls,kv", GREEDY_CASES)
def test_greedy_engine_matches_reference_and_plain(models, cls, kv):
    tol = TOL if kv == "f32" else TOL_QUANT
    te = _engine(TORCH, models, cls, kv, k=4, max_streams=3)
    got = _run(te, _greedy_reqs(TORCH))
    je = _engine(JAX, models, cls, kv, k=4, max_streams=3)
    _assert_same(got, _run(je, _greedy_reqs(JAX)), tol)
    assert (te.accepted, te.drafted) == (je.accepted, je.drafted)
    assert te.drafted > 0 and te.acceptance_rate < 1.0
    plain = _plain(models, "paged" if "Paged" in cls else "dense", kv)
    assert [g[:2] for g in got] == [p[:2] for p in plain]
    if "Paged" in cls:  # every page back when the streams retire
        assert te.allocator.available == te.pool.n_pages - 1
    if kv == "int4":  # the draft's dense cache pairs an int4 pool with int8
        assert te.d_cache.k.dtype == torch.int8


def test_engine_interleaved_admission(models):
    """A stream admitted mid-flight (chunked prefill) joins the rounds."""
    def run(side):
        e = _engine(side, models, "SpeculativeEngine", k=3, max_streams=2,
                    n_batch=4)
        req = JReq if side == JAX else TReq
        a = e.submit(req(prompt=[2, 3], max_tokens=10))
        e.step()
        e.step()
        b = e.submit(req(prompt=[5, 6] * 6, max_tokens=6))
        while e.has_work():
            e.step()
        return [(e.finished[i].tokens, "".join(e.finished[i].text))
                for i in (a, b)], (e.accepted, e.drafted)

    assert run(TORCH) == run(JAX)


@pytest.mark.parametrize("cls", ["SpeculativeEngine",
                                 "PagedSpeculativeEngine"])
def test_engine_self_draft_accepts_everything(models, cls):
    e = _engine(TORCH, models, cls, self_draft=True, k=4, max_streams=1)
    got = _run(e, _greedy_reqs(TORCH, [[2, 3]], 12))
    plain = _plain(models, "paged" if "Paged" in cls else "dense", "f32",
                   [[2, 3]], 12)
    assert [g[:2] for g in got] == [p[:2] for p in plain]
    assert e.acceptance_rate > 0.9


def test_engine_submit_guards(models):
    e = _engine(TORCH, models, "SpeculativeEngine", max_streams=1)
    with pytest.raises(ValueError):
        e.submit(TReq(prompt=[2], max_tokens=2,
                      sampler=t_default_samplers()))
    s = _engine(TORCH, models, "SampledSpeculativeEngine", max_streams=1)
    with pytest.raises(ValueError):  # a host sampler chain only
        s.submit(TReq(prompt=[2], max_tokens=2))
    for bad in (dict(repeat_penalty=1.2), dict(mirostat=2),
                dict(tail_free_z=0.9), dict(typical_p=0.9),
                dict(top_a=(0.1, 0.0))):
        with pytest.raises(ValueError, match="speculative serving"):
            s.submit(TReq(prompt=[2], max_tokens=2, device_sampler=TDS(
                kind="sample", temperature=0.8, **bad)))
    # greedy converts to the degenerate sample, top-k 1
    greedy = TReq(prompt=[2], max_tokens=2, device_sampler=TDS.greedy())
    s.submit(greedy)
    assert (greedy.device_sampler.kind, greedy.device_sampler.top_k) == \
        ("sample", 1)
    with pytest.raises(ValueError, match="context"):
        tsp.SpeculativeEngine(models[TORCH][0], models["short_ctx_draft"])


SAMPLED_CASES = [("SampledSpeculativeEngine", "f32", {}),
                 ("PagedSampledSpeculativeEngine", "f32", {}),
                 ("PagedSampledSpeculativeEngine", "int8", {}),
                 ("PagedSampledSpeculativeEngine", "f32", {"n_pages": 3})]


@pytest.mark.parametrize("cls,kv,extra", SAMPLED_CASES)
def test_sampled_engine_matches_reference(models, monkeypatch, cls, kv,
                                          extra):
    """Given the reference's uniforms, the draft samples the reference's
    proposals, and the host acceptance (each stream's numpy rng) gives
    its tokens and counts; a pool of 3 pages falls back to per-token
    steps for some rounds."""
    tol = TOL if kv == "f32" else TOL_QUANT
    te = _engine(TORCH, models, cls, kv, k=3, max_streams=2, **extra)
    _reference_draw(monkeypatch, te)
    got = _run(te, _sampled_reqs(TORCH, 3))
    je = _engine(JAX, models, cls, kv, k=3, max_streams=2, **extra)
    _assert_same(got, _run(je, _sampled_reqs(JAX, 3)), tol)
    assert (te.accepted, te.drafted) == (je.accepted, je.drafted)
    assert all(g[0] for g in got)
    if "Paged" in cls:
        assert te.allocator.available == te.pool.n_pages - 1


def test_sampled_engine_seeded_and_self_draft(models):
    """The port's own draw: seeded runs repeat; with the target as its own
    draft p == q and everything is accepted."""
    def run(seed, self_draft=False):
        e = _engine(TORCH, models, "SampledSpeculativeEngine", k=3,
                    max_streams=2, self_draft=self_draft)
        return [g[:2] for g in _run(e, _sampled_reqs(TORCH, seed))], e

    (a, _), (b, _) = run(3), run(3)
    assert a == b
    _, e = run(5, self_draft=True)
    assert e.acceptance_rate == 1.0


def test_sampled_greedy_conversion_matches_plain(models, monkeypatch):
    e = _engine(TORCH, models, "SampledSpeculativeEngine", k=3,
                max_streams=1)
    got = _run(e, [TReq(prompt=[2, 3], max_tokens=10, seed=0,
                        device_sampler=TDS.greedy())])
    assert [g[:2] for g in got] == [p[:2] for p in _plain(
        models, "dense", "f32", [[2, 3]], 10)]


def test_sampled_top_p_self_draft_exact_q(models):
    """With top-p and min-p the host q must be the device proposal
    distribution exactly: a self-draft then accepts everything."""
    e = _engine(TORCH, models, "SampledSpeculativeEngine", self_draft=True,
                k=4, max_streams=1)
    _run(e, [TReq(prompt=[2, 3], max_tokens=12, seed=2,
                  device_sampler=TDS(kind="sample", temperature=0.9,
                                     top_k=30, top_p=0.7, min_p=0.02))])
    assert e.acceptance_rate == 1.0


def test_paged_prefix_cache_borrow(models):
    """The same prompt twice: the second borrows its full prompt pages,
    and the dense draft cache is prefilled over the borrowed region (a
    wiped draft cache holds rows there again before any round)."""
    prompt = list(range(2, 21))  # 19 tokens + BOS = 20: 2 full pages of 8

    def run(side):
        e = _engine(side, models, "PagedSpeculativeEngine", k=3,
                    max_streams=1, page_size=8, prefix_cache=True)
        outs = [_run(e, _greedy_reqs(side, [prompt], 8)) for _ in range(2)]
        return outs, e

    got, te = run(TORCH)
    ref, _ = run(JAX)
    for g, r in zip(got, ref):
        _assert_same(g, r)
    assert got[0][0][:2] == got[1][0][:2]
    assert te.prefix_cache.evictable == 2

    te.d_cache.k.zero_()
    te.submit(TReq(prompt=prompt, max_tokens=4))
    te._admit()
    stream = te.slots[0]
    assert stream is not None and stream.prefill_pos == 16  # borrowed
    assert te.d_cache.k[:, 0, :, :16].abs().sum() > 0
    while te.has_work():
        te.step()


def test_paged_tight_pool_falls_back(models):
    """A pool of 3 pages of 4 rows (beside the trash page) holds the
    stream's 12 positions but not the k-token rounds near its end: those
    fall back to the plain paged step, as the reference's do."""
    def run(side):
        e = _engine(side, models, "PagedSpeculativeEngine", k=4,
                    max_streams=1, page_size=4, n_pages=4)
        fallback, calls = e._fallback_step, []
        e._fallback_step = lambda: calls.append(1) or fallback()
        return _run(e, _greedy_reqs(side, [[2, 3]], 10)), len(calls)

    (got, n), (ref, n_ref) = run(TORCH), run(JAX)
    _assert_same(got, ref)
    assert n == n_ref > 0
    assert [g[:2] for g in got] == [p[:2] for p in _plain(
        models, "paged", "f32", [[2, 3]], 10, page_size=4, n_pages=4)]


def test_context_boundary_falls_back(models):
    """Streams near n_ctx: the rounds shrink, then fall back to the plain
    step, and retire with context_full as the reference's."""
    prompt = list(range(2, 58))

    def run(side, cls):
        e = _engine(side, models, cls, k=4, max_streams=1, n_batch=16)
        return _run(e, _greedy_reqs(side, [prompt], 20))

    for cls in ("SpeculativeEngine", "PagedSpeculativeEngine"):
        got = run(TORCH, cls)
        _assert_same(got, run(JAX, cls))
        assert got[0][2] == "context_full"


def test_fallback_step_repairs_draft_cache(models):
    """After per-token fallbacks, the emitted token is evaluated into the
    DRAFT cache too: with draft == target every later round accepts all
    of its proposals but the last, and the tokens stay plain greedy."""
    target = models[TORCH][0]
    e = tsp.SpeculativeEngine(target, target, k=4, max_streams=2,
                              kv_dtype=torch.float32)
    forced = {"n": 2}
    orig = e._reserve_round

    def deny_twice(decodable, k):
        if forced["n"] > 0:
            forced["n"] -= 1
            return False
        return orig(decodable, k)

    e._reserve_round = deny_twice
    rid = e.submit(TReq(prompt=[2, 9], max_tokens=12, sampler=TGreedy()))
    rounds, prev = [], (0, 0)
    while e.has_work():
        e.step()
        d, a = e.drafted - prev[0], e.accepted - prev[1]
        prev = (e.drafted, e.accepted)
        if d:
            rounds.append((d, a))
    toks = e.finished[rid].tokens[2:]  # strip the prompt
    assert toks == _j_greedy(models[JAX][0], [2, 9], 12)[: len(toks)]
    assert forced["n"] == 0 and rounds
    for d, a in rounds[:-1]:
        assert a == d, rounds


# -- the graph path's host side ----------------------------------------------


class _Replay:
    """Stand-in for a captured graph: a replay re-runs the captured step's
    closure on its static buffers, so whatever a call changes must reach
    the step through the buffers."""

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
    monkeypatch.setattr(tsp, "_on_card", lambda graph, dev: graph)
    return captured


def test_session_graph_path_gives_eager_tokens(pair, fake_graphs):
    """Verify, bonus and draft graphs keyed per shape, each captured once
    and replayed with the round's inputs loaded into its buffers."""
    prompt = [2, 9, 4]
    ref = _session(JAX, pair, 4)
    ref.feed_prompt(prompt)
    got = _session(TORCH, pair, 4)
    got.feed_prompt(prompt)
    assert got.generate(16) == ref.generate(16)
    np.testing.assert_allclose(got.last_logits, ref.last_logits, **TOL)
    keys = [k for k in got.t_cache.graphs if k[0] == "forward"]
    assert {k[3] for k in keys} >= {1, 4}  # T = 1 (bonus) and k (verify)
    replays = sum(g.replays for g in got.t_cache.graphs.values())
    assert replays > len(fake_graphs) // 2


@pytest.mark.parametrize("cls", ["SpeculativeEngine",
                                 "SampledSpeculativeEngine"])
def test_engine_graph_path_gives_eager_tokens(models, monkeypatch,
                                              fake_graphs, cls):
    sampled = cls.startswith("Sampled")
    te = _engine(TORCH, models, cls, k=3, max_streams=2)
    if sampled:
        _reference_draw(monkeypatch, te)
    got = _run(te, _sampled_reqs(TORCH, 3) if sampled
               else _greedy_reqs(TORCH, PROMPTS[:2]))
    je = _engine(JAX, models, cls, k=3, max_streams=2)
    _assert_same(got, _run(je, _sampled_reqs(JAX, 3) if sampled
                           else _greedy_reqs(JAX, PROMPTS[:2])))
    kinds = {k[0] for k in te.d_cache.graphs}
    assert ("draft_q" if sampled else "dense") in kinds
    assert any(k[0] == "forward" and k[3] == 3 for k in te.cache.graphs)
