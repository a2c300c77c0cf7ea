"""The port's serving engines, transformers parity and the learned-position
cap on the architectures besides LLaMA:

- MPT (ALiBi, tied head) and Falcon (multi-query) through the dense and
  the paged engine against the JAX package's, host-stepped and in decode
  blocks of 4 (`generate_all(n_steps=4)`), on a dense f32 cache and on
  int8 and int4 pools, at head dims 64 (MPT Q4_K), 80 and 256 (Falcon
  Q4_0, 4 and 2 query heads a kv head): greedy tokens and text equal;
- every exporter of tests/hf_export.py (the seven architectures, and
  Falcon-40B's grouped kv heads) loaded by the port: logits against
  transformers' own forward within rtol = atol = 2e-3, the reference's
  tolerance (tests/test_models.py:61), and argmax equal;
- a GPT-2 file whose position table is 32 rows, loaded with a context of
  64: both packages cap the context at 32 and give the same logits
  (atol = rtol = 1e-5, as test_torch_model.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_archs import (  # noqa: F401 (an autouse fixture)
    load_both,
    one_torch_thread,
)

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu import paged as jpaged
from llm_tpu import serve as jserve
from llm_tpu.ggml.types import GgmlType
from llm_tpu.ops import sampling as js
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import paged as tpaged
from llm_tpu_torch import serve as tserve
from llm_tpu_torch.ops import sampling as ts
from llm_tpu_torch.samplers import build_sampler_chain as t_chain

TOL = dict(rtol=1e-5, atol=1e-5)
KV = {"f32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
      "int4": ("int4", "int4")}
BAN = ((0, float("-inf")),)  # the tiny vocab's EoT
PROMPTS = [[2, 3], [9, 4, 5] * 7, [7] * 30]
JAX = (jserve, jpaged, js, j_chain)
TORCH = (tserve, tpaged, ts, t_chain)
# (id, architecture, format, hparam overrides): head dims 64, 80, 256
ENGINE_MODELS = [
    ("mpt-d64-q4_k", "mpt", GgmlType.Q4_K, dict(n_embd=256, n_head=4)),
    ("falcon-d80-q4_0", "falcon", GgmlType.Q4_0, dict(n_embd=320,
                                                      n_head=4)),
    ("falcon-d256-q4_0", "falcon", GgmlType.Q4_0, dict(n_embd=512,
                                                       n_head=2)),
]


@pytest.fixture(scope="module", params=ENGINE_MODELS,
                ids=[m[0] for m in ENGINE_MODELS])
def models(request, tmp_path_factory):
    name, arch, et, overrides = request.param
    path = tmp_path_factory.mktemp(f"torch_archs_{name}") / "m.bin"
    make_tiny_file(arch, path, et, **overrides)
    return load_both(path, arch)


def _engine(side, model, kind, kv):
    serve, paged = side[:2]
    dtype = KV[kv][0 if side is JAX else 1]
    if kind == "paged":
        return paged.PagedEngine(model, kv_dtype=dtype, n_batch=8,
                                 max_streams=2, page_size=16)
    return serve.Engine(model, kv_dtype=dtype, n_batch=8, max_streams=2)


def _run(side, engine, n_steps):
    """PROMPTS on two slots, 10 greedy tokens each (the host chain
    `topk:k=1`, whose default slot is a repetition penalty of 1.3 over 64
    tokens, and its device form; EoT banned): (tokens, text) each."""
    request = side[0].GenerationRequest
    sampling, chain = side[2:]
    reqs = [request(prompt=p, max_tokens=10,
                    sampler=chain(["topk:k=1"], bias=list(BAN)),
                    device_sampler=sampling.DeviceSampler(
                        kind="greedy", repeat_penalty=1.3,
                        penalty_last_n=64, bias=BAN))
            for p in PROMPTS]
    before = set(engine.finished)
    engine.generate_all(reqs, n_steps=n_steps)
    ids = sorted(set(engine.finished) - before)
    return [(engine.finished[i].tokens, "".join(engine.finished[i].text))
            for i in ids]


@pytest.mark.parametrize("kind,kv", [("dense", "f32"), ("paged", "int8"),
                                     ("paged", "int4")])
def test_engine_texts_match_reference(models, kind, kv):
    jm, tm = models
    ref = _run(JAX, _engine(JAX, jm, kind, kv), 1)
    host = _run(TORCH, _engine(TORCH, tm, kind, kv), 1)
    te = _engine(TORCH, tm, kind, kv)
    blocks = _run(TORCH, te, 4)
    assert len(ref) == len(PROMPTS)
    assert all(t for _, t in ref)
    assert host == ref
    assert blocks == ref
    assert te.multi_blocks > 0
    assert sum(te.multi_fallbacks.values()) == 0


# -- transformers parity -----------------------------------------------------


IDS = np.array([3, 17, 5, 9, 22, 1, 8, 40], dtype=np.int32)
HF = ["llama", "gpt2", "gptj", "gptneox", "bloom", "mpt", "falcon",
      "falcon40"]


@pytest.mark.parametrize("exporter", HF)
def test_hf_parity(exporter, tmp_path):
    """The port's logits of IDS in chunks of 5 and 3 (a prefill, then a
    chunk over the cache) against transformers' forward of the same
    random model: the reference's check for its own package."""
    from hf_export import EXPORTERS, export_falcon40

    path = tmp_path / f"{exporter}_hf.bin"
    if exporter == "falcon40":
        hf_model, arch = export_falcon40(path, kv=2), "falcon"
    else:
        hf_model, arch = EXPORTERS[exporter](path), exporter
    m = tloader.load(path, arch,
                     params=tloader.ModelParameters(context_size=64),
                     device="cpu")
    if exporter == "falcon40":
        assert m.spec.n_head_kv == 2
        assert m.spec.residual == "parallel_two_ln"
    with torch.no_grad():
        ref = hf_model(torch.tensor(IDS[None].astype(np.int64))).logits[0]
    cache = tfwd.init_cache(m.spec, torch.float32, "cpu")
    got = []
    for start, n in ((0, 5), (5, 3)):
        logits, _, cache = tfwd.forward_step(
            m.spec, m.params, torch.tensor(IDS[start:start + n]), start,
            cache)
        got.append(logits)
    got = torch.cat(got).numpy()
    ref = ref.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


# -- the learned-position cap ------------------------------------------------


def test_learned_positions_cap_the_context(tmp_path):
    path = tmp_path / "gpt2_ctx32.bin"
    make_tiny_file("gpt2", path, GgmlType.Q8_0, n_ctx=32)
    jm, tm = load_both(path, "gpt2", ctx=64)
    assert jm.spec.n_ctx == tm.spec.n_ctx == tm.context_size == 32
    assert tm.params.wpe.shape == (64, 32)
    ids = np.random.default_rng(5).integers(1, 96, 31).tolist()
    jc = jfwd.init_cache(jm.spec, jnp.float32)
    tc = tfwd.init_cache(tm.spec, torch.float32)
    n_past = 0
    for chunk in (ids[:20], ids[20:30], ids[30:]):
        jl, _, jc = jfwd.forward_step(jm.spec, jm.params,
                                      jnp.asarray(chunk, jnp.int32),
                                      jnp.int32(n_past), jc)
        tl, _, tc = tfwd.forward_step(tm.spec, tm.params,
                                      torch.tensor(chunk), n_past, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        n_past += len(chunk)
    # a dummy position past the table takes its last row, as the
    # reference's gather does (a masked stream's rows in a decode block)
    pos = torch.tensor([[31, 40]])
    h = tfwd.embed_batched(tm.spec, tm.params, torch.tensor([[5, 5]]), pos)
    assert torch.equal(h[0, 0], h[0, 1])
