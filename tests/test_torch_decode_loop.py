"""The port's on-device decode loop against the JAX package's, on tiny LLaMA
Q4_0 checkpoints written by `make_tiny_file`: the forward's device-`n_past`
step, `forward.decode_loop` (greedy, sampled with penalties, mirostat 1
and 2), `InferenceSession.infer_device` (across a window bucket, and with
EoT mid-block), `infer --device-sampling` through the CLI, and the cached
ALiBi slopes.

Tolerances: the device-`n_past` step is bit-equal to the host-int one (the
same ops on the same values). Logits against the reference within
atol = rtol = 1e-5, the tolerance of test_torch_model.py (f32 on both
sides, sums in another order). Tokens and text equal: the sampled runs are
handed the uniforms the reference draws from its key schedule (a split
per step, `uniform(sub, (V,), 1e-20, 1.0)`). Mirostat's mu within atol
1e-5 (the f32 `log` and `exp2` of the two libraries)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu import session as jsession
from llm_tpu.cli import main as j_main
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops import sampling as js
from llm_tpu.ops.layers import alibi_slopes as j_alibi_slopes
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import session as tsession
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.ops import sampling as ts
from llm_tpu_torch.samplers import GreedySampler

TOL = dict(rtol=1e-5, atol=1e-5)
MU_TOL = dict(rtol=0, atol=1e-5)
TKV = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8"}
EOT = 0  # make_tiny_file's EoT token


def _load(path, ctx):
    jm = j_load(path, "llama", params=JModelParameters(context_size=ctx))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=ctx),
                      device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_decode_loop") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    return (path, *_load(path, 64))


def _prefill(jm, tm, prompt):
    """Both caches (f32) after `prompt`, and the logits of its last row."""
    jc = jfwd.init_cache(jm.spec, jnp.float32)
    tc = tfwd.init_cache(tm.spec, torch.float32)
    jl, _, jc = jfwd.forward_step(jm.spec, jm.params,
                                  jnp.asarray(prompt, jnp.int32),
                                  jnp.int32(0), jc)
    tl, _, tc = tfwd.forward_step(tm.spec, tm.params, torch.tensor(prompt),
                                  0, tc)
    np.testing.assert_allclose(tl[-1].numpy(), np.asarray(jl[-1]), **TOL)
    return jc, tc, jl[-1], tl[-1]


def _prompt(n=11, seed=3):
    return np.random.default_rng(seed).integers(1, 96, n).tolist()


def _ref_uniforms(key, n_steps, V=96):
    """The uniforms the reference's decode_loop draws from `key`."""
    us = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(sub, (V,), minval=1e-20,
                                                maxval=1.0)))
    return torch.from_numpy(np.stack(us))


# -- the device-n_past step ------------------------------------------------


@pytest.mark.parametrize("kv", list(TKV))
def test_device_npast_step_bit_equal(tiny, kv):
    _, _, tm = tiny
    spec, params = tm.spec, tm.params
    prompt = _prompt(13)
    caches, outs = [], []
    for as_tensor in (False, True):
        cache = tfwd.init_cache(spec, TKV[kv])
        tfwd.forward_batched(spec, params, torch.tensor([prompt]), [0], cache)
        n_past = torch.tensor([13], dtype=torch.int32) if as_tensor else [13]
        logits, h, _ = tfwd.forward_batched(spec, params, torch.tensor([[5]]),
                                            n_past, cache, 64)
        caches.append(cache)
        outs.append((logits, h))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(caches[0], name), getattr(caches[1], name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("n_past", [[0, 3], [60, 62], [64, -2]])
def test_cache_write_clamps_like_dynamic_update_slice(tiny, n_past):
    """All layers' rows at each stream's own position, one stream masked
    out; a start past S - T is clamped to it (and a negative one to 0)."""
    spec = tiny[2].spec
    L, H, S, D, T = spec.n_layer, spec.n_head_kv, spec.n_ctx, spec.head_dim, 3
    cache = tfwd.init_cache_batched(spec, 3, torch.float32)
    rng = np.random.default_rng(4)
    news = [torch.from_numpy(rng.normal(size=(3, T, H, D)).astype(np.float32))
            for _ in range(2 * L)]
    npast = torch.tensor(n_past + [7], dtype=torch.int32)
    tfwd.write_cache_batched(cache, news[:L], news[L:], npast,
                             write_mask=[True, True, False])
    want_k = torch.zeros_like(cache.k)
    want_v = torch.zeros_like(cache.v)
    for b, p in enumerate(n_past):
        start = min(max(p, 0), S - T)
        for l in range(L):
            want_k[l, b, :, start:start + T] = news[l][b].transpose(0, 1)
            want_v[l, b, :, start:start + T] = news[L + l][b].transpose(0, 1)
    assert torch.equal(cache.k, want_k) and torch.equal(cache.v, want_v)


def test_alibi_slopes_cached(tiny):
    base = tiny[2].spec
    for n_head, n_head_kv in ((8, 8), (12, 4), (6, 1)):
        spec = replace(base, n_head=n_head, n_head_kv=n_head_kv,
                       alibi_bias_max=8.0)
        got = tfwd._slopes(spec, "cpu")
        ref = np.asarray(j_alibi_slopes(n_head, 8.0)).reshape(
            n_head_kv, n_head // n_head_kv)
        assert np.array_equal(got.numpy(), ref)
        assert tfwd._slopes(spec, torch.device("cpu")) is got  # built once
    assert tfwd._slopes(base, "cpu") is None  # LLaMA has none


# -- decode_loop -----------------------------------------------------------


def test_decode_loop_greedy_matches_reference(tiny):
    _, jm, tm = tiny
    jc, tc, jl, tl = _prefill(jm, tm, _prompt())
    jt, jlog, jn, jc = jfwd.decode_loop(jm.spec, jm.params, jl,
                                        jnp.int32(11), jc, 6, 64)
    tt, tlog, tn, tc2 = tfwd.decode_loop(tm.spec, tm.params, tl.numpy(), 11,
                                         tc, 6, 64)
    assert tc2 is tc and tt.dtype == torch.int32
    assert tt.tolist() == np.asarray(jt).tolist()
    assert int(tn) == int(jn) == 17
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    # the cache rows the loop wrote
    np.testing.assert_allclose(tc.k[:, :, :, :17].numpy(),
                               np.asarray(jc.k)[:, :, :, :17], **TOL)


SAMPLED = dict(kind="sample", temperature=0.7, top_k=12, repeat_penalty=1.3,
               frequency_penalty=0.1, presence_penalty=0.2, penalty_last_n=8,
               bias=((EOT, float("-inf")),))


def test_decode_loop_sampled_matches_reference(tiny):
    _, jm, tm = tiny
    prompt = _prompt()
    jc, tc, jl, tl = _prefill(jm, tm, prompt)
    jcfg, tcfg = js.DeviceSampler(**SAMPLED), ts.DeviceSampler(**SAMPLED)
    jst = {k: v[0] for k, v in js.penalty_state([prompt], 8, 96).items()}
    tst = {k: v[0] for k, v in ts.penalty_state([prompt], 8, 96).items()}
    key = jax.random.PRNGKey(11)
    jt, jlog, _, _, jfin = jfwd.decode_loop(
        jm.spec, jm.params, jl, jnp.int32(11), jc, 8, 64, jcfg, key, jst,
        return_state=True)
    tt, tlog, _, _, tfin = tfwd.decode_loop(
        tm.spec, tm.params, tl.numpy(), 11, tc, 8, 64, tcfg,
        penalty_state=tst, return_state=True,
        uniforms=_ref_uniforms(key, 8))
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert set(tfin) == set(jfin) == {"counts", "ring", "pos"}
    for k in tfin:
        assert np.array_equal(tfin[k].numpy(), np.asarray(jfin[k])), k


@pytest.mark.parametrize("kind", [1, 2])
def test_decode_loop_mirostat_matches_reference(tiny, kind):
    _, jm, tm = tiny
    jc, tc, jl, tl = _prefill(jm, tm, _prompt())
    kw = dict(kind="sample", temperature=0.9, mirostat=kind,
              mirostat_tau=3.0, mirostat_m=20)
    jcfg, tcfg = js.DeviceSampler(**kw), ts.DeviceSampler(**kw)
    key = jax.random.PRNGKey(5)
    jt, _, _, _, jfin = jfwd.decode_loop(
        jm.spec, jm.params, jl, jnp.int32(11), jc, 8, 64, jcfg, key,
        {"mu": jnp.float32(6.0)}, return_state=True)
    tt, _, _, _, tfin = tfwd.decode_loop(
        tm.spec, tm.params, tl.numpy(), 11, tc, 8, 64, tcfg,
        penalty_state={"mu": torch.tensor(6.0)}, return_state=True,
        uniforms=_ref_uniforms(key, 8))
    assert tt.tolist() == np.asarray(jt).tolist()
    assert set(tfin) == set(jfin) == {"mu", "mu_steps"}
    np.testing.assert_allclose(tfin["mu_steps"].numpy(),
                               np.asarray(jfin["mu_steps"]), **MU_TOL)
    np.testing.assert_allclose(float(tfin["mu"]), float(jfin["mu"]),
                               **MU_TOL)


def test_decode_loop_checks_window_and_uniforms(tiny):
    _, _, tm = tiny
    cache = tfwd.init_cache(tm.spec, torch.float32)
    logits = np.zeros(96, np.float32)
    with pytest.raises(ValueError, match="does not cover"):
        tfwd.decode_loop(tm.spec, tm.params, logits, 60, cache, 8, 64)
    with pytest.raises(ValueError, match="uniforms"):
        tfwd.decode_loop(tm.spec, tm.params, logits, 0, cache, 4, 64,
                         ts.DeviceSampler.top_k_temperature(),
                         uniforms=torch.full((3, 96), 0.5))


# -- infer_device ----------------------------------------------------------


def _cfg(mod, n_batch=8):
    return mod.InferenceSessionConfig(
        memory_k_type=mod.ModelKVMemoryType.Float32,
        memory_v_type=mod.ModelKVMemoryType.Float32, n_batch=n_batch)


def _infer_device(mod, model, prompt, n, sampler, n_steps, seed=0,
                  n_batch=8, halt_on_eot=True):
    sess = mod.InferenceSession(model, _cfg(mod, n_batch))
    texts = []
    sess.infer_device(prompt, n, sampler=sampler, n_steps=n_steps, seed=seed,
                      callback=texts.append, halt_on_eot=halt_on_eot)
    return sess, "".join(texts)


def test_infer_device_greedy_matches_infer_and_reference(tiny):
    _, jm, tm = tiny
    prompt = "<t2><t3><t9>"
    js_, jtext = _infer_device(jsession, jm, prompt, 12,
                               js.DeviceSampler.greedy(), 5)
    ts_, ttext = _infer_device(tsession, tm, prompt, 12,
                               ts.DeviceSampler.greedy(), 5)
    host = tsession.InferenceSession(tm, _cfg(tsession))
    htexts = []
    host.infer(tsession.InferenceRequest(
        prompt=prompt, maximum_token_count=12,
        parameters=tsession.InferenceParameters(sampler=GreedySampler())),
        rng=np.random.default_rng(0),
        callback=lambda r: htexts.append(r.text)
        if r.kind == "inferred_token" else None)
    assert ts_.tokens == js_.tokens == host.tokens
    assert len(ts_.tokens) > 4
    assert ttext == jtext == "".join(htexts)
    assert ts_.n_past == js_.n_past == host.n_past
    np.testing.assert_allclose(ts_.last_logits, js_.last_logits, **TOL)
    np.testing.assert_allclose(ts_.last_logits, host.last_logits, **TOL)


def test_infer_device_crosses_window_bucket(tmp_path):
    """A 1024-token context: the prompt ends below 512, the blocks run at
    windows 512 and then 1024."""
    path = tmp_path / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jm, tm = _load(path, 1024)
    prompt = _prompt(505, seed=6)
    ban = ((EOT, float("-inf")),)
    js_, jtext = _infer_device(jsession, jm, prompt, 12,
                               js.DeviceSampler(bias=ban), 4, n_batch=64)
    ts_, ttext = _infer_device(tsession, tm, prompt, 12,
                               ts.DeviceSampler(bias=ban), 4, n_batch=64)
    assert tfwd.window_bucket(505 + 4, 1024) == 512
    assert tfwd.window_bucket(513 + 4, 1024) == 1024
    assert ts_.tokens == js_.tokens and len(ts_.tokens) == 505 + 12
    assert ttext == jtext
    np.testing.assert_allclose(ts_.last_logits, js_.last_logits, **TOL)


def _eot_bias_mid_block(tm, prompt, n_steps):
    """A bias on EoT that lets greedy decoding pick it first at a step
    inside the first block (not its first or last step): the bias must
    exceed that step's gap max(logits) - logits[EoT] and no earlier one."""
    sess = tsession.InferenceSession(tm, _cfg(tsession))
    sess.feed_prompt(prompt)
    gaps = []
    for _ in range(n_steps):
        lg = sess.last_logits
        gaps.append(float(lg.max() - lg[EOT]))
        sess._evaluate([int(np.argmax(np.where(np.arange(96) == EOT,
                                               -np.inf, lg)))], None)
    for t in range(1, n_steps - 1):
        if gaps[t] < min(gaps[:t]):
            return (gaps[t] + min(gaps[:t])) / 2, t
    pytest.fail(f"no step of the block is closer to EoT than the ones "
                f"before it: {gaps}")


def test_infer_device_eot_mid_block(tiny):
    _, jm, tm = tiny
    prompt = _prompt(9, seed=12)
    b, t = _eot_bias_mid_block(tm, prompt, 6)
    bias = ((EOT, b),)
    js_, jtext = _infer_device(jsession, jm, prompt, 12,
                               js.DeviceSampler(bias=bias), 6)
    ts_, ttext = _infer_device(tsession, tm, prompt, 12,
                               ts.DeviceSampler(bias=bias), 6)
    assert ts_.tokens[-1] == EOT and len(ts_.tokens) == 9 + t + 1
    assert ts_.tokens == js_.tokens and ttext == jtext
    assert ts_.n_past == js_.n_past == 9 + t + 1
    np.testing.assert_allclose(ts_.last_logits, js_.last_logits, **TOL)


def test_infer_device_same_seed_same_tokens(tiny):
    _, _, tm = tiny
    cfg = ts.DeviceSampler(kind="sample", temperature=1.5, top_k=20,
                           repeat_penalty=1.2, bias=((EOT, float("-inf")),))
    runs = [_infer_device(tsession, tm, "<t4><t5>", 10, cfg, 4, seed=s)[0]
            .tokens for s in (9, 9)]
    assert runs[0] == runs[1] and len(runs[0]) == 2 + 1 + 10


def test_infer_device_mirostat_mu_persists(tiny):
    _, _, tm = tiny
    cfg = ts.DeviceSampler(kind="sample", mirostat=2, mirostat_tau=3.0)
    sess, _ = _infer_device(tsession, tm, "<t4><t5>", 6, cfg, 4, seed=1,
                            halt_on_eot=False)
    mu = sess._mirostat_mu
    assert np.isfinite(mu) and mu != ts.mirostat_mu_init(cfg)
    assert sess._mirostat_sampler == cfg


# -- CLI -------------------------------------------------------------------


def test_cli_device_sampling_same_text(tiny, capsys):
    path = tiny[0]
    argv = ["infer", "-m", str(path), "-a", "llama", "-p", "<t2><t3><t9>",
            "-n", "6", "--seed", "3", "-s", "topk:k=1", "--ignore-eos",
            "--num-ctx-tokens", "64", "--device-sampling", "--decode-steps",
            "4"]
    j_main(argv)
    ref = capsys.readouterr().out
    t_main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref and got.count("<t") == 6


@pytest.mark.parametrize("opts", [["seqrepetition:flat_penalty=0.5"],
                                  ["mirostat2", "topk:k=5"],
                                  ["mirostat1:tau=4", "minp:p=0.1"]])
def test_cli_device_sampling_rejects_alike(tiny, opts):
    argv = ["infer", "-m", str(tiny[0]), "-a", "llama", "-p", "<t2>", "-n",
            "2", "--num-ctx-tokens", "64", "--device-sampling"]
    for o in opts:
        argv += ["-s", o]
    with pytest.raises((SystemExit, ValueError)) as ref:
        j_main(argv)
    with pytest.raises((SystemExit, ValueError)) as got:
        t_main(argv + ["--device", "cpu"])
    assert type(got.value).__name__ == type(ref.value).__name__
    assert str(got.value) == str(ref.value)


# -- the graph's host side -------------------------------------------------


def test_decode_graphs_keyed_and_bounded(tiny):
    """One graph entry per (window, sampler, penalty shapes, mu, block
    capacity) on the cache; a block of fewer steps reuses its capacity's
    entry, and the least recently used entry goes past the bound."""
    _, _, tm = tiny
    cache = tfwd.init_cache(tm.spec, torch.float32)
    greedy = ts.DeviceSampler.greedy()
    pst = {k: v[0] for k, v in ts.penalty_state([[1, 2]], 8, 96).items()}
    g = tfwd._graph_for(tm.spec, tm.params, cache, 64, greedy, None, False, 8)
    assert g.graph is None and g.state["toks"].shape == (8,)
    assert tfwd._graph_for(tm.spec, tm.params, cache, 64, greedy, None,
                           False, 5) is g
    other = [tfwd._graph_for(tm.spec, tm.params, cache, 64, greedy, pst,
                             False, 8),
             tfwd._graph_for(tm.spec, tm.params, cache, 32, greedy, None,
                             False, 8),
             tfwd._graph_for(tm.spec, tm.params, cache, 64, greedy, None,
                             False, 16)]
    assert len({id(x) for x in [g, *other]}) == 4
    assert other[0].state["ring"].shape == (8,) and "u" not in g.state
    sampled = tfwd._graph_for(tm.spec, tm.params, cache, 64,
                              ts.DeviceSampler(kind="sample", bias=((3, 1.0),)),
                              None, False, 4)
    assert sampled.state["u"].shape == (4, 96) and sampled.bias[3] == 1.0
    # reuse moves g last; filling past the bound drops the oldest others
    tfwd._graph_for(tm.spec, tm.params, cache, 64, greedy, None, False, 8)
    for w in range(tfwd._MAX_GRAPHS):
        tfwd._graph_for(tm.spec, tm.params, cache, 100 + w, greedy, None,
                        False, 8)
    assert len(cache.graphs) == tfwd._MAX_GRAPHS
    kept = {id(x) for x in cache.graphs.values()}
    assert not kept & {id(x) for x in [g, *other]}


def test_attention_workspace_keeps_outgrown_buffers(monkeypatch):
    """A graph captured over a stream's workspace keeps pointing at it:
    an outgrown buffer stays allocated, and growing during a capture
    raises."""
    from llm_tpu_torch.ops import paged_attention as pa

    monkeypatch.setattr(pa, "_WORK", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    dev = torch.device("cpu")
    part, tickets = pa._workspace(dev, 1, 100, 8)
    assert pa._workspace(dev, 1, 50, 8) == (part, tickets)
    part2, tickets2 = pa._workspace(dev, 1, 200, 8)
    assert part2.numel() == 200 and tickets2 is tickets
    assert any(t is part for t in pa._WORK[(None, 1)][2])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert pa._workspace(dev, 1, 200, 8)[0] is part2
    with pytest.raises(RuntimeError, match="capture"):
        pa._workspace(dev, 1, 400, 8)
