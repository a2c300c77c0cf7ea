"""The port's perplexity (`InferenceSession.perplexity` over
`forward.nll_step`) against the JAX package's, on tiny checkpoints written
by the JAX package's `make_tiny_file` and loaded by both packages:

- a LLaMA Q4_0 at context 64 (one sub-chunk a chunk, the first scored
  position 32) and at context 1024 (two sub-chunks of 512, so the second
  reads the first's keys from the cache and the first scored position is
  512), over an f32 cache;
- MPT Q4_0 (ALiBi, the tied head) at context 64;
- an int8 cache at context 1024;
- `nll_step` alone, at n_past 0 and after a sub-chunk, with the targets
  and the valid positions of a chunk.

The port reads the cache through `window_bucket`'s window, the reference
through the whole context; masked positions add nothing either way.
Tolerance: each chunk's perplexity within rtol 1e-5 of the reference's,
the NLL sums within rtol 1e-5 (f32 on both sides, sums in another order:
test_torch_model.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_archs import load_both, one_torch_thread  # noqa: F401

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu import session as jsession
from llm_tpu.ggml.types import GgmlType
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import session as tsession

RTOL = 1e-5
CASES = [("llama", 64, "f32"), ("llama", 1024, "f32"), ("mpt", 64, "f32"),
         ("llama", 1024, "int8")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_perplexity")
    out = {}
    for arch in ("llama", "mpt"):
        out[arch] = d / f"{arch}.bin"
        make_tiny_file(arch, out[arch], GgmlType.Q4_0)
    return out


def _session(side, model, kv):
    t = side.ModelKVMemoryType.Int8 if kv == "int8" else \
        side.ModelKVMemoryType.Float32
    return side.InferenceSession(
        model, side.InferenceSessionConfig(memory_k_type=t, memory_v_type=t))


@pytest.mark.parametrize("arch,ctx,kv", CASES,
                         ids=[f"{a}-ctx{c}-{k}" for a, c, k in CASES])
def test_perplexity_matches_reference(files, arch, ctx, kv):
    jm, tm = load_both(files[arch], arch, ctx)
    tokens = list(np.random.default_rng(ctx).integers(1, 96, 3 * ctx + 7))
    ref, got = [], []
    _session(jsession, jm, kv).perplexity(tokens,
                                          lambda i, p: ref.append((i, p)))
    sess = _session(tsession, tm, kv)
    sess.perplexity(tokens, lambda i, p: got.append((i, p)))
    assert [i for i, _ in got] == [0, 1, 2]
    assert [i for i, _ in ref] == [0, 1, 2]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref],
                               rtol=RTOL, atol=0)
    assert sess.n_past == ctx  # the last chunk's context


def test_nll_step_matches_reference(files):
    """Two sub-chunks of a context-1024 chunk: the first at n_past 0 (its
    first half unscored), the second over the first's cached keys."""
    ctx = 1024
    jm, tm = load_both(files["llama"], "llama", ctx)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 96, ctx).astype(np.int32)
    targets = np.zeros(ctx, np.int32)
    targets[:-1] = ids[1:]
    pos = np.arange(ctx)
    valid = (pos >= 300) & (pos <= ctx - 2)
    jc = jfwd.init_cache(jm.spec, jnp.float32)
    tc = tfwd.init_cache(tm.spec, torch.float32, "cpu")
    for p in (0, 512):
        sl = slice(p, p + 512)
        js, jc = jfwd.nll_step(jm.spec, jm.params, jnp.asarray(ids[sl]),
                               jnp.asarray(targets[sl]),
                               jnp.asarray(valid[sl]), jnp.int32(p), jc,
                               ctx)
        ts, tc = tfwd.nll_step(tm.spec, tm.params,
                               torch.from_numpy(ids[sl].astype(np.int64)),
                               torch.from_numpy(targets[sl].astype(np.int64)),
                               torch.from_numpy(valid[sl]), p, tc, p + 512)
        assert ts.shape == () and ts.dtype == torch.float32
        np.testing.assert_allclose(float(ts), float(js), rtol=RTOL, atol=0)
    with pytest.raises(ValueError, match="does not cover"):
        tfwd.nll_step(tm.spec, tm.params, torch.from_numpy(ids[:512]),
                      torch.from_numpy(targets[:512]),
                      torch.from_numpy(valid[:512]), 512, tc, 512)
