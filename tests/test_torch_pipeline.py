"""The port's pipeline parallelism (llm_tpu_torch.parallel.pipeline, GPipe
over a `pipe` axis with send and receive), mirroring tests/test_pipeline.py
in one gloo world of 4 ranks on the CPU
(tests/torch_parallel_worlds.pipeline_world): logits and the updated
cache equal the single-device forward_batched's (rtol = atol = 1e-4; int8
codes within 1), and the JAX package's pipeline on its virtual mesh of
the same shape; the write mask keeps masked streams' rows; an uneven
stage split is refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.loader as jloader
import llm_tpu.models.forward as jfwd
import llm_tpu.parallel.pipeline as jpipe
import llm_tpu_torch.models.forward as tfwd
import torch_parallel_worlds as worlds
from llm_tpu.ggml.types import GgmlType
from llm_tpu_torch.parallel import launch
from llm_tpu_torch.testing import make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(4, 1, 4, "plain"), (2, 2, 2, "plain"), (4, 1, 2, "plain"),
         (2, 2, 2, "decode"), (4, 1, 2, "int8"), (2, 2, 2, "mask"),
         (4, 1, 2, "step")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline")
    files = {"llama4": str(d / "llama4.bin"), "llama": str(d / "llama.bin")}
    # n_layer = 4 so the stack splits into 2 or 4 stages
    make_tiny_file("llama", files["llama4"], GgmlType.Q4_0, n_layer=4)
    make_tiny_file("llama", files["llama"], GgmlType.Q4_0)
    res = launch.spawn(worlds.pipeline_world, 4, "gloo", d / "store",
                       timeout=300, args=(files, CASES))
    return files, res


@pytest.fixture(scope="module")
def models(world):
    files, _ = world
    return (worlds.load(files["llama4"], "llama"),
            jloader.load(files["llama4"], "llama",
                         params=jloader.ModelParameters(context_size=64)))


def _assemble(res, case):
    """The whole batch's logits and cache from the ranks' slices."""
    pipe, data, M, kind = case
    B = 4
    out = {}
    parts = [r[case] for r in res]
    logits = [None] * data
    for p in parts:
        logits[p["coords"]["data"]] = p["logits"]
    out["logits"] = np.concatenate(logits)
    for name in ("k", "v", "k_scale"):
        if parts[0][name] is None:
            continue
        shape = list(parts[0][name].shape)
        shape[0] *= pipe
        shape[1] *= data
        full = np.zeros(shape, parts[0][name].dtype)
        for p in parts:
            s, d = p["coords"]["pipe"], p["coords"]["data"]
            a = p[name]
            full[s * a.shape[0]:(s + 1) * a.shape[0],
                 d * a.shape[1]:(d + 1) * a.shape[1]] = a
        out[name] = full
    out["ids"] = parts[0]["ids"]
    assert out["logits"].shape[0] == B
    return out


def _ref(model, ids, kv):
    """forward_batched on one device; a decode case runs the prompt and
    then the last column as one step."""
    B = ids.shape[0]
    cache = tfwd.init_cache_batched(model.spec, B, kv)
    return tfwd.forward_batched(model.spec, model.params,
                                torch.as_tensor(ids), [0] * B, cache)


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "plain"])
def test_pipeline_matches_batched(world, models, case):
    _, res = world
    tm, jm = models
    got = _assemble(res, case)
    for r in res[1:]:  # every stage returns its data row's logits
        d = r[case]["coords"]["data"]
        same = [x for x in res if x[case]["coords"]["data"] == d][0]
        assert r[case]["logits"].tobytes() == same[case]["logits"].tobytes()
    lg, _, cache = _ref(tm, got["ids"], torch.float32)
    np.testing.assert_allclose(got["logits"], lg.numpy(), **TOL)
    np.testing.assert_allclose(got["k"], cache.k.numpy(), **TOL)
    np.testing.assert_allclose(got["v"], cache.v.numpy(), **TOL)

    pipe, data, M, _ = case
    mesh = jpipe.make_pipeline_mesh(pipe=pipe, data=data)
    params = jpipe.shard_params_pipeline(jm.params, mesh)
    jc = jpipe.shard_cache_pipeline(
        jfwd.init_cache_batched(jm.spec, 4, jnp.float32), mesh)
    jl, _, _ = jpipe.pipeline_forward_batched(
        jm.spec, params, jnp.asarray(got["ids"], jnp.int32),
        jnp.zeros(4, jnp.int32), jc, mesh, M)
    np.testing.assert_allclose(got["logits"], np.asarray(jl), **TOL)


def test_pipeline_decode_continuation(world, models):
    """Prefill then a decode step through the pipeline: the cache
    threads."""
    _, res = world
    tm, _ = models
    got = _assemble(res, (2, 2, 2, "decode"))
    ids = got["ids"]
    B, T = ids.shape[0], ids.shape[1] - 1
    cache = tfwd.init_cache_batched(tm.spec, B, torch.float32)
    tfwd.forward_batched(tm.spec, tm.params, torch.as_tensor(ids[:, :T]),
                         [0] * B, cache)
    lg, _, _ = tfwd.forward_batched(tm.spec, tm.params,
                                    torch.as_tensor(ids[:, T:]), [T] * B,
                                    cache)
    np.testing.assert_allclose(got["logits"], lg.numpy(), **TOL)
    np.testing.assert_allclose(got["k"], cache.k.numpy(), **TOL)


def test_pipeline_int8_cache(world, models):
    _, res = world
    tm, _ = models
    got = _assemble(res, (4, 1, 2, "int8"))
    lg, _, cache = _ref(tm, got["ids"], "int8")
    np.testing.assert_allclose(got["logits"], lg.numpy(), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["k"].astype(np.int32),
                               cache.k.numpy().astype(np.int32), atol=1)
    np.testing.assert_allclose(got["k_scale"], cache.k_scale.numpy(),
                               rtol=1e-4, atol=1e-6)


def test_pipeline_write_mask(world):
    """Masked streams leave the cache untouched through the pipeline."""
    _, res = world
    k = _assemble(res, (2, 2, 2, "mask"))["k"]
    assert np.abs(k[:, 0]).max() > 0 and np.abs(k[:, 2]).max() > 0
    assert np.abs(k[:, 1]).max() == 0
    assert np.abs(k[:, 3]).max() == 0


def test_pipeline_step_runs_twice(world):
    """pipeline_step checks the window and threads the cache."""
    _, res = world
    got = _assemble(res, (4, 1, 2, "step"))
    assert np.isfinite(got["logits"]).all()


def test_uneven_layers_rejected(world):
    _, res = world
    for r in res:
        assert "must divide evenly into 4 pipeline stages" in r["uneven"]
