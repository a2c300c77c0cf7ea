"""The port's dense continuous-batching engine (llm_tpu_torch.serve.Engine)
against the JAX package's (llm_tpu.serve.Engine), on a tiny LLaMA Q4_0
checkpoint: the same greedy tokens and text, the logits of every step
within atol = rtol = 1e-5, the same finish reasons, retirement events and
logprobs, for f32, bf16 and int8 caches, more requests than slots, and a
T=1 prefill chunk at the context boundary (a decode-shaped pass over a
strided view of one slot of the batched cache).

Tolerance: both packages run f32 on the CPU; the sums run in another order
(torch vs XLA), which moves logits of magnitude ~0.2 by a few 1e-8: atol =
rtol = 1e-5. With an int8 cache, a value that sits within that noise of a
rounding tie may get the neighbouring code (one V code of ~2.7k in
`test_engine_matches_reference[int8]`), which moves every later logit by
~1.5e-5: that case holds logits to atol 5e-5, tokens and text still
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import serve as jserve
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import serve as tserve
from llm_tpu_torch.ops import dense_attention
from llm_tpu_torch.samplers import build_sampler_chain as t_chain

CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_QUANT = dict(rtol=1e-5, atol=5e-5)  # one code at a rounding tie
KV = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16), "int8": ("int8", "int8")}
JAX = (jserve.Engine, jserve.GenerationRequest, j_chain)
TORCH = (tserve.Engine, tserve.GenerationRequest, t_chain)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_serve") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jm = j_load(path, "llama", params=JModelParameters(context_size=CTX))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    return jm, tm


def _engine(side, models, kv, **kw):
    engine_cls = side[0]
    model = models[0] if side is JAX else models[1]
    return engine_cls(model, kv_dtype=KV[kv][0 if side is JAX else 1], **kw)


def _run(side, engine, prompts, n, ban_eot=True, **req):
    """Run `prompts` greedily to completion. Returns, per request, (tokens,
    text, finish reason, logits rows each generated token was sampled
    from, logprob entries)."""
    _, request, chain = side
    bias = [(0, float("-inf"))] if ban_eot else []
    ids = [engine.submit(request(prompt=p, max_tokens=n,
                                 sampler=chain(["topk:k=1"], bias=bias),
                                 **req)) for p in prompts]
    rows = {i: [] for i in ids}
    while engine.has_work():
        engine.step()
        for s in engine.slots:
            if s is not None and s.request_id in rows and not s.prefilling:
                rows[s.request_id].append(np.array(s.last_logits,
                                                   np.float32))
    out = []
    for i in ids:
        s = engine.finished[i]
        out.append((s.tokens, "".join(s.text), s.finish_reason,
                    np.stack(rows[i]) if rows[i] else None, s.logprob_data))
    return out


def _assert_same(got, ref, tol=TOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
        if r[3] is None:
            assert g[3] is None
        else:
            np.testing.assert_allclose(g[3], r[3], **tol)


PROMPTS = [[2, 3], [9, 4, 5] * 7, [7] * 30]


@pytest.mark.parametrize("kv", list(KV))
def test_engine_matches_reference(models, kv):
    """Three requests on two slots: the third waits for a free slot."""
    kw = dict(max_streams=2, n_batch=8)
    got = _run(TORCH, _engine(TORCH, models, kv, **kw), PROMPTS, 10)
    ref = _run(JAX, _engine(JAX, models, kv, **kw), PROMPTS, 10)
    _assert_same(got, ref, TOL_QUANT if kv == "int8" else TOL)
    assert all(g[1] for g in got) and all(g[2] == "max_tokens" for g in got)


def test_t1_chunk_at_context_boundary(models, monkeypatch):
    """n_batch 20 and a 61-token prompt: the chunk at position 60 would
    pad past the 64-token context, so it runs at its exact shape, T=1,
    through the dense-attention pass over slot 1's strided view."""
    shapes = []
    inner = dense_attention.dense_attention_pass

    def spy(spec, cache_k, *a, **k):
        shapes.append(tuple(cache_k.shape))
        return inner(spec, cache_k, *a, **k)

    monkeypatch.setattr(dense_attention, "dense_attention_pass", spy)
    prompts = [[4, 5], list(np.random.default_rng(1).integers(1, 96, 61))]
    kw = dict(max_streams=2, n_batch=20)
    got = _run(TORCH, _engine(TORCH, models, "f32", **kw), prompts, 2)
    ref = _run(JAX, _engine(JAX, models, "f32", **kw), prompts, 2)
    _assert_same(got, ref)
    L, Hkv, D = models[1].spec.n_layer, models[1].spec.n_head_kv, \
        models[1].spec.head_dim
    assert (L, 1, Hkv, CTX, D) in shapes  # the one-slot view took the pass


def test_context_full_finish_reason(models):
    """No max_tokens: the stream retires when the context fills."""
    prompts = [list(range(2, 60))]
    kw = dict(max_streams=1, n_batch=16)
    got = _run(TORCH, _engine(TORCH, models, "int8", **kw), prompts, None)
    ref = _run(JAX, _engine(JAX, models, "int8", **kw), prompts, None)
    _assert_same(got, ref)
    assert got[0][2] == "context_full"


def test_logprobs_match_reference(models):
    kw = dict(max_streams=2, n_batch=8)
    got = _run(TORCH, _engine(TORCH, models, "f32", **kw), PROMPTS[:2], 4,
               logprobs=3)
    ref = _run(JAX, _engine(JAX, models, "f32", **kw), PROMPTS[:2], 4,
               logprobs=3)
    _assert_same(got, ref)
    for g, r in zip(got, ref):
        assert len(g[4]) == len(r[4]) == 4
        for ge, re_ in zip(g[4], r[4]):
            assert ge["token"] == re_["token"]
            assert list(ge["top_logprobs"]) == list(re_["top_logprobs"])
            np.testing.assert_allclose(ge["logprob"], re_["logprob"], **TOL)


def test_overlong_and_empty_prompts_retire(models):
    engine = _engine(TORCH, models, "f32", max_streams=1)
    long_id = engine.submit(tserve.GenerationRequest(prompt=[2] * 70,
                                                     max_tokens=4))
    events = engine.step()
    assert (long_id, "", True) in events
    assert engine.finished[long_id].finish_reason == "context_full"
    empty_id = engine.submit(tserve.GenerationRequest(prompt=[],
                                                      max_tokens=4))
    events = engine.step()
    assert (empty_id, "", True) in events
    assert engine.finished[empty_id].finish_reason.startswith("error")
    assert not engine.has_work()


def test_cancel_pending_and_running(models):
    """Seeded streams of the default sampler chain with EoT banned: neither
    can retire before the cancels (an unseeded stream could sample EoT)."""
    engine = _engine(TORCH, models, "f32", max_streams=1, n_batch=8)
    texts = []
    eot = [(0, float("-inf"))]
    a = engine.submit(tserve.GenerationRequest(
        prompt=[2, 3], max_tokens=20, sampler=t_chain(bias=eot), seed=25,
        on_token=lambda rid, t: texts.append((rid, t))))
    b = engine.submit(tserve.GenerationRequest(
        prompt=[4, 5], max_tokens=20, sampler=t_chain(bias=eot), seed=26))
    engine.step()
    engine.step()
    assert engine.cancel(b) and engine.cancel(a)
    assert not engine.cancel(a)
    assert not engine.has_work()
    assert engine.finished[a].finish_reason == "cancelled"
    assert engine.finished[b].finish_reason == "cancelled"
    assert texts and all(rid == a for rid, _ in texts)


def test_throughput_stats(models):
    engine = _engine(TORCH, models, "f32", max_streams=2, n_batch=8)
    reqs = [tserve.GenerationRequest(prompt=p, max_tokens=5)
            for p in PROMPTS[:2]]
    texts, tok_s = tserve.throughput_stats(engine, reqs)
    assert len(texts) == 2 and tok_s > 0
    assert sum(s.generated for s in engine.finished.values()) <= 10
