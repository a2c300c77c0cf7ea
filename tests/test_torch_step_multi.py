"""The port's multi-step serving (`Engine.step_multi`, `PagedEngine.
step_multi` through `generate_all(n_steps=4)`) against the JAX package's
engines, and against the port's own host-stepped `step()`, on a tiny LLaMA
Q4_0 checkpoint (context 64, V = 96):

- greedy texts and tokens (with the host chain's default repetition
  penalty as a device sampler) on dense f32 / int8 caches and f32 / int8 /
  int4 pools, more requests than slots;
- EoT in the middle of a block, max_tokens cut inside a block, a stream
  at the context boundary (the counted fallback to `step()`);
- `_plan_multi` halving a block on a tight pool, then its counted
  fallback;
- a slot prefilling beside the blocks, its borrowed prefix page unchanged;
- logprob records;
- sampled blocks (per-stream temperature, top-k, top-p, penalties, bias,
  mirostat 2) with the engine's draw replaced by the reference's key
  schedule, and a batch mixing mirostat 1 and 2 (the counted fallback).

Tolerances: last logits and logprobs within atol = rtol = 1e-5 (f32 on both
sides; int8 / int4: 5e-5, a code at a rounding tie, test_torch_serve.py);
mirostat's mu within atol 1e-5. Texts and tokens equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import paged as jpaged
from llm_tpu import serve as jserve
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops import sampling as js
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import paged as tpaged
from llm_tpu_torch import serve as tserve
from llm_tpu_torch.ops import sampling as ts
from llm_tpu_torch.samplers import build_sampler_chain as t_chain

CTX, V = 64, 96
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_QUANT = dict(rtol=1e-5, atol=5e-5)
MU_TOL = dict(rtol=0, atol=1e-5)
KV = {"f32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
      "int4": ("int4", "int4")}
BAN = ((0, float("-inf")),)  # the tiny vocab's EoT
PROMPTS = [[2, 3], [9, 4, 5] * 7, [7] * 30]
JAX = (jserve, js, j_chain)
TORCH = (tserve, ts, t_chain)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_step_multi") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jm = j_load(path, "llama", params=JModelParameters(context_size=CTX))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    return jm, tm


@pytest.fixture(autouse=True)
def reference_step_waits(monkeypatch):
    """The reference's `PagedEngine.step` dispatches `paged_step` with its
    page tables as a zero-copy view (`jnp.asarray(self.tables)` on the
    CPU), then retires a context-full stream and clears its table row,
    sometimes before the dispatched step has read it: that stream's last
    logits then vary from run to run. Waiting for the step's outputs
    before the engine goes on gives the tables as they were at dispatch,
    as a TPU's copy of them does."""
    step = jpaged.paged_step
    monkeypatch.setattr(
        jpaged, "paged_step",
        lambda *a, **kw: jax.block_until_ready(step(*a, **kw)))


def _engine(side, models, kind, kv, **kw):
    model = models[0] if side is JAX else models[1]
    dtype = KV[kv][0 if side is JAX else 1]
    if kind == "paged":
        cls = jpaged.PagedEngine if side is JAX else tpaged.PagedEngine
        kw.setdefault("page_size", 16)
    else:
        cls = side[0].Engine
    return cls(model, kv_dtype=dtype, n_batch=8, **kw)


def _greedy(side, bias=BAN):
    """The host chain `topk:k=1` (its default slot: repetition 1.3 over
    64 tokens) and its device form."""
    _, sampling, chain = side
    return dict(sampler=chain(["topk:k=1"], bias=list(bias)),
                device_sampler=sampling.DeviceSampler(
                    kind="greedy", repeat_penalty=1.3, penalty_last_n=64,
                    bias=bias))


def _run(side, engine, prompts, n, n_steps=4, **req):
    """Run `prompts` to completion; per request (tokens, text, finish
    reason, last logits, logprob entries)."""
    request = side[0].GenerationRequest
    reqs = [request(prompt=p, max_tokens=n, **{**_greedy(side), **req})
            for p in prompts]
    before = set(engine.finished)
    engine.generate_all(reqs, n_steps=n_steps)
    ids = sorted(set(engine.finished) - before)
    return [(engine.finished[i].tokens, "".join(engine.finished[i].text),
             engine.finished[i].finish_reason,
             np.asarray(engine.finished[i].last_logits, np.float32),
             engine.finished[i].logprob_data) for i in ids]


def _assert_same(got, ref, tol=TOL, logits=True):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
        if logits:
            np.testing.assert_allclose(g[3], r[3], **tol)


CASES = [("dense", "f32"), ("dense", "int8"), ("paged", "f32"),
         ("paged", "int8"), ("paged", "int4")]


@pytest.mark.parametrize("kind,kv", CASES)
def test_greedy_blocks_match_reference_and_step(models, kind, kv):
    """Three requests on two slots (the third admitted after a block), 10
    new tokens each in blocks of 4: the last block is cut at max_tokens."""
    tol = TOL if kv == "f32" else TOL_QUANT
    te = _engine(TORCH, models, kind, kv, max_streams=2)
    got = _run(TORCH, te, PROMPTS, 10)
    ref = _run(JAX, _engine(JAX, models, kind, kv, max_streams=2), PROMPTS,
               10)
    _assert_same(got, ref, tol)
    assert all(g[2] == "max_tokens" and g[0].count(0) == 0 for g in got)
    assert te.multi_blocks > 0 and te.multi_block_steps >= 3 * 8 // 2
    assert te.multi_fallbacks == {"mixed_mirostat": 0, "tight_pool": 0,
                                  "context_full": 0}
    # the host-stepped path on the same kernels gives the same text (its
    # last logits are those of the last kept token, not of the block's end)
    host = _run(TORCH, _engine(TORCH, models, kind, kv, max_streams=2),
                PROMPTS, 10, n_steps=1)
    _assert_same(got, host, logits=False)


def _eot_bias_mid_block(models, prompt, n_steps):
    """A bias on EoT with which greedy decoding (no penalty) first picks
    it at a step inside the first block, not its first or last step: the
    gap max(logits) - logits[EoT] of each step's row, read as the host
    samples it."""
    engine = _engine(TORCH, models, "dense", "f32", max_streams=1)
    gaps = []
    sample = engine._host_sample

    def recording(stream):
        gaps.append(float(stream.last_logits.max() - stream.last_logits[0]))
        return sample(stream)

    engine._host_sample = recording
    engine.submit(tserve.GenerationRequest(
        prompt=prompt, max_tokens=n_steps,
        sampler=t_chain(["topk:k=1", "repetition:penalty=1.0"],
                        bias=list(BAN))))
    while engine.has_work():
        engine.step()
    for t in range(1, n_steps - 1):
        if gaps[t] < min(gaps[:t]):
            return (gaps[t] + min(gaps[:t])) / 2, t
    pytest.fail(f"no step of the block is closer to EoT than the ones "
                f"before it: {gaps}")


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_eot_mid_block(models, kind):
    """The stream keeps its tokens up to the EoT, its n_past rewound past
    the block's overshoot; the next request reuses the slot."""
    prompt = np.random.default_rng(12).integers(1, V, 9).tolist()
    b, t = _eot_bias_mid_block(models, prompt, 6)
    runs = []
    for side in (TORCH, JAX):
        _, sampling, chain = side
        req = side[0].GenerationRequest
        engine = _engine(side, models, kind, "f32", max_streams=1)
        reqs = [req(prompt=prompt, max_tokens=12,
                    sampler=chain(["topk:k=1", "repetition:penalty=1.0"],
                                  bias=[(0, b)]),
                    device_sampler=sampling.DeviceSampler(bias=((0, b),))),
                req(prompt=[4, 5], max_tokens=5, **_greedy(side))]
        engine.generate_all(reqs, n_steps=6)
        runs.append([engine.finished[i] for i in (0, 1)])
    (ta, tb), (ja, jb) = runs
    assert ta.finish_reason == "eot" and ta.tokens[-1] == 0
    assert len(ta.tokens) == 9 + t + 1 and ta.n_past == 9 + t + 1
    assert ta.tokens == ja.tokens and ta.n_past == ja.n_past
    assert tb.tokens == jb.tokens and tb.finish_reason == "max_tokens"
    np.testing.assert_allclose(tb.last_logits, jb.last_logits, **TOL)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_context_full_and_boundary_fallback(models, kind):
    """A 52-token prompt decodes in blocks to the context's end; a 63-token
    prompt has no room for a block: one counted step() retires it."""
    prompts = [list(range(2, 54)), [5] * 63]
    te = _engine(TORCH, models, kind, "f32", max_streams=1)
    got = _run(TORCH, te, prompts, None)
    ref = _run(JAX, _engine(JAX, models, kind, "f32", max_streams=1),
               prompts, None)
    _assert_same(got, ref)
    assert [g[2] for g in got] == ["context_full"] * 2
    assert te.multi_fallbacks["context_full"] == 1


def test_tight_pool_halves_then_falls_back(models):
    """Two streams of 14-token prompts, one page each and one spare: the
    first block halves to 2 steps (no new page needed), the next cannot
    fit even 2 (a page for each stream) and falls back to step(), which
    gives the spare page to one stream and retires the other (kv_oom)."""
    prompts = [list(range(2, 16)), list(range(20, 34))]
    te = _engine(TORCH, models, "paged", "f32", max_streams=2, n_pages=4)
    blocks = []
    inner = te._dispatch_multi

    def spy(logits, n_past, n_steps, *a, **k):
        out = inner(logits, n_past, n_steps, *a, **k)
        blocks.append(None if out is None else out[2])
        return out

    te._dispatch_multi = spy
    got = _run(TORCH, te, prompts, 4)
    ref = _run(JAX, _engine(JAX, models, "paged", "f32", max_streams=2,
                            n_pages=4), prompts, 4)
    _assert_same(got, ref, logits=False)
    assert blocks[:2] == [2, None]
    assert te.multi_fallbacks["tight_pool"] >= 1
    assert sorted(g[2] for g in got) == ["kv_oom", "max_tokens"]


def test_prefilling_slot_beside_blocks(models):
    """A stream borrows a registered prefix page and prefills in chunks of
    8 while the other decodes in blocks: its dummy rows park at its
    prefill frontier, so the shared page stays as it was."""
    first = np.random.default_rng(3).integers(1, V, 20).tolist()
    second = first[:16] + np.random.default_rng(4).integers(1, V, 22).tolist()
    runs = []
    for side in (TORCH, JAX):
        req = side[0].GenerationRequest
        engine = _engine(side, models, "paged", "int8", max_streams=2,
                         prefix_cache=True)
        a = engine.submit(req(prompt=first, max_tokens=16, **_greedy(side)))
        while engine.slots[0] is None or engine.slots[0].prefilling:
            engine.step_multi(4)
        b = engine.submit(req(prompt=second, max_tokens=4, **_greedy(side)))
        engine.step_multi(4)
        stream = engine.slots[1]
        assert stream.prefilling and stream.prefill_pos == 24
        shared = int(engine.tables[1, 0])
        assert shared == int(engine.tables[0, 0])  # borrowed
        if side is TORCH:
            page = [t[:, shared].clone() for t in
                    (engine.pool.k, engine.pool.v, engine.pool.k_scale)]
        while engine.has_work():
            engine.step_multi(4)
            if side is TORCH:
                assert all(torch.equal(t[:, shared], p) for t, p in
                           zip((engine.pool.k, engine.pool.v,
                                engine.pool.k_scale), page))
        runs.append([engine.finished[i].tokens for i in (a, b)])
    assert runs[0] == runs[1]


def test_logprob_records(models):
    """Logprob requests ride the blocks: records equal the reference's
    blocks' and the host step's."""
    kw = dict(max_streams=2)
    got = _run(TORCH, _engine(TORCH, models, "paged", "f32", **kw),
               PROMPTS[:2], 6, logprobs=3)
    ref = _run(JAX, _engine(JAX, models, "paged", "f32", **kw), PROMPTS[:2],
               6, logprobs=3)
    host = _run(TORCH, _engine(TORCH, models, "paged", "f32", **kw),
                PROMPTS[:2], 6, n_steps=1, logprobs=3)
    _assert_same(got, ref)
    _assert_same(got, host, logits=False)
    for g, r, h in zip(got, ref, host):
        assert len(g[4]) == len(r[4]) == len(h[4]) == 6
        for ge, re_, he in zip(g[4], r[4], h[4]):
            assert ge["token"] == re_["token"] == he["token"]
            assert list(ge["top_logprobs"]) == list(re_["top_logprobs"]) \
                == list(he["top_logprobs"])
            for other in (re_, he):
                np.testing.assert_allclose(ge["logprob"], other["logprob"],
                                           **TOL)
                np.testing.assert_allclose(
                    list(ge["top_logprobs"].values()),
                    list(other["top_logprobs"].values()), **TOL)


def _reference_draw(monkeypatch, engine):
    """Replace the engine's draw with the reference engine's key schedule:
    the loop key split once a block, then a split a step."""
    state = {"key": jax.random.PRNGKey(0)}

    def draw(self, n_steps, draw):
        state["key"] = jax.random.split(state["key"])[0]
        if not draw:
            return None
        k, us = state["key"], []
        for _ in range(n_steps):
            k, sub = jax.random.split(k)
            us.append(np.asarray(jax.random.uniform(
                sub, (self.max_streams, V), minval=1e-20, maxval=1.0)))
        return torch.from_numpy(np.stack(us))

    monkeypatch.setattr(engine, "_block_uniforms",
                        draw.__get__(engine, type(engine)))


MIX = [dict(kind="sample", temperature=0.9, mirostat=2, mirostat_tau=3.0,
            repeat_penalty=1.2),
       dict(kind="sample", temperature=0.7, top_k=12, top_p=0.9,
            frequency_penalty=0.3, bias=((5, 2.0),)),
       dict(kind="sample", temperature=1.2, min_p=0.05, bias=BAN),
       dict(repeat_penalty=1.4, bias=BAN)]
CHAINS = [["mirostat2:tau=3.0", "repetition:penalty=1.2",
           "temperature:0.9"],
          ["topk:k=12", "topp:p=0.9", "freqpresence:frequency=0.3",
           "temperature:0.7"],
          ["minp:p=0.05", "temperature:1.2"], ["topk:k=1"]]


def _mixed_requests(side, mix=MIX, chains=CHAINS,
                    prompts=PROMPTS + [[3, 1]]):
    """Per-stream samplers (device forms and host chains), seeded."""
    _, sampling, chain = side
    req = side[0].GenerationRequest
    return [req(prompt=p, max_tokens=9, seed=i,
                sampler=chain(c, n_vocab=V),
                device_sampler=sampling.DeviceSampler(**m))
            for i, (p, m, c) in enumerate(zip(prompts, mix, chains))]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sampled_blocks_match_reference(models, kind, monkeypatch):
    """Four streams, each its own sampler, on three slots: the same tokens
    as the reference's blocks given its uniforms, the same mu carried."""
    te = _engine(TORCH, models, kind, "f32", max_streams=3)
    _reference_draw(monkeypatch, te)
    je = _engine(JAX, models, kind, "f32", max_streams=3)
    tt = te.generate_all(_mixed_requests(TORCH), n_steps=4)
    jt = je.generate_all(_mixed_requests(JAX), n_steps=4)
    assert tt == jt
    for rid in jt:
        t, j = te.finished[rid], je.finished[rid]
        assert t.tokens == j.tokens and t.finish_reason == j.finish_reason
        assert (t.mirostat_mu is None) == (j.mirostat_mu is None)
        if j.mirostat_mu is not None:
            np.testing.assert_allclose(t.mirostat_mu, j.mirostat_mu,
                                       **MU_TOL)
    assert te.multi_blocks > 0 and not any(te.multi_fallbacks.values())


def test_mixed_mirostat_falls_back(models):
    """Mirostat 1 beside mirostat 2 (both decoding from the first call)
    cannot share a block: every step is a counted host step, with each
    stream's mu carried both ways."""
    mix = [dict(kind="sample", mirostat=1, mirostat_m=20),
           dict(kind="sample", mirostat=2)]
    chains = [["mirostat1:m=20"], ["mirostat2"]]
    prompts = [[2, 3], [4, 5]]
    te = _engine(TORCH, models, "dense", "f32", max_streams=2)
    je = _engine(JAX, models, "dense", "f32", max_streams=2)
    tt = te.generate_all(_mixed_requests(TORCH, mix, chains, prompts),
                         n_steps=4)
    jt = je.generate_all(_mixed_requests(JAX, mix, chains, prompts),
                         n_steps=4)
    assert tt == jt
    assert te.multi_fallbacks["mixed_mirostat"] >= 9 and te.multi_blocks == 0
    for rid in jt:
        np.testing.assert_allclose(te.finished[rid].mirostat_mu,
                                   je.finished[rid].mirostat_mu, **MU_TOL)


def test_step_multi_needs_device_samplers(models):
    engine = _engine(TORCH, models, "dense", "f32", max_streams=1)
    engine.submit(tserve.GenerationRequest(prompt=[2, 3], max_tokens=2))
    with pytest.raises(ValueError, match="device_sampler"):
        while engine.has_work():
            engine.step_multi(4)
