"""The port's ring-attention prefill (llm_tpu_torch.parallel.ring),
mirroring tests/test_ring.py in one gloo world of 4 ranks on the CPU
(tests/torch_parallel_worlds.ring_world): the last logits equal the
ordinary batched prefill's and the JAX package's ring on its virtual
seq mesh of 4 (rtol = atol = 2e-4, as the reference's test), every rank
holds the same cache, and greedy decode continues token for token from
it. A ring of one runs in this process, over a gloo world of one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import llm_tpu.loader as jloader
import llm_tpu.parallel.ring as jring
import llm_tpu_torch.models.forward as tfwd
import torch_parallel_worlds as worlds
from llm_tpu_torch.models.forward import KVCache
from llm_tpu_torch.parallel import launch
from llm_tpu_torch.parallel.ring import make_seq_mesh, ring_prefill
from llm_tpu_torch.testing import make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = {"llama": {}, "mpt": {}, "falcon": {"n_embd": 512}}
IDS = np.random.default_rng(0).integers(2, 90, size=(2, 16))
IDS8 = np.random.default_rng(1).integers(2, 90, size=(1, 32))
CASES = [(a, IDS, None) for a in ARCHS] + [("llama", IDS8, "int8")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ring")
    files = {}
    for arch, kw in ARCHS.items():
        files[arch] = str(d / f"{arch}.bin")
        make_tiny_file(arch, files[arch], **kw)
    res = launch.spawn(worlds.ring_world, 4, "gloo", d / "store",
                       timeout=300, args=(files, CASES))
    return files, res


def _dense_prefill(model, ids, kv):
    B = ids.shape[0]
    cache = tfwd.init_cache_batched(model.spec, B, kv)
    logits, _, cache = tfwd.forward_batched(model.spec, model.params,
                                            torch.as_tensor(ids), [0] * B,
                                            cache)
    return logits[:, -1, :].numpy(), cache


def _decode_greedy(model, last, cache, n_past, steps=6):
    B = last.shape[0]
    toks = []
    last = torch.as_tensor(last)
    for i in range(steps):
        t = torch.argmax(last, dim=-1)
        toks.append(t.numpy())
        logits, _, cache = tfwd.forward_batched(
            model.spec, model.params, t[:, None], [n_past + i] * B, cache)
        last = logits[:, 0, :]
    return np.stack(toks)


def _cache(part):
    def t(name):
        a = part[name]
        return None if a is None else torch.from_numpy(a)

    return KVCache(k=t("k"), v=t("v"), k_scale=t("k_scale"),
                   v_scale=t("v_scale"))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ring_prefill_matches_dense(world, arch):
    files, res = world
    model = worlds.load(files[arch], arch)
    part = res[0][(arch, None)]
    for r in res[1:]:
        assert r[(arch, None)]["last"].tobytes() == part["last"].tobytes()
        assert r[(arch, None)]["k"].tobytes() == part["k"].tobytes()
    dense_last, dense_cache = _dense_prefill(model, IDS, torch.float32)
    np.testing.assert_allclose(part["last"], dense_last, **TOL)
    np.testing.assert_allclose(part["k"], dense_cache.k.numpy(), **TOL)
    np.testing.assert_allclose(part["v"], dense_cache.v.numpy(), **TOL)
    # greedy decode from both caches agrees token for token
    ring_cache = _cache(part)
    rt = _decode_greedy(model, part["last"], ring_cache, 16)
    dt = _decode_greedy(model, dense_last, dense_cache, 16)
    np.testing.assert_array_equal(rt, dt)

    jm = jloader.load(files[arch], arch,
                      params=jloader.ModelParameters(context_size=64))
    jl, _ = jring.ring_prefill(jm.spec, jm.params, jnp.asarray(IDS),
                               jring.make_seq_mesh(4), kv_dtype=jnp.float32)
    np.testing.assert_allclose(part["last"], np.asarray(jl), **TOL)


def test_ring_prefill_int8_cache(world):
    files, res = world
    model = worlds.load(files["llama"], "llama")
    part = res[0][("llama", "int8")]
    dense_last, dense_cache = _dense_prefill(model, IDS8, "int8")
    assert part["k"].dtype == np.int8 and part["k_scale"] is not None
    rt = _decode_greedy(model, part["last"], _cache(part), 32)
    dt = _decode_greedy(model, dense_last, dense_cache, 32)
    np.testing.assert_array_equal(rt, dt)


def test_ring_prefill_ring_of_one(world, tmp_path):
    """A ring of one rank degenerates to the plain local path."""
    files, _ = world
    model = worlds.load(files["llama"], "llama")
    ids = np.asarray([[2, 3, 4, 5]])
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        last, _ = ring_prefill(model.spec, model.params, torch.as_tensor(ids),
                               make_seq_mesh(device="cpu"),
                               kv_dtype=torch.float32)
    finally:
        dist.destroy_process_group()
    dense_last, _ = _dense_prefill(model, ids, torch.float32)
    np.testing.assert_allclose(last.numpy(), dense_last, **TOL)


def test_ring_asserts(world, tmp_path):
    files, _ = world
    model = worlds.load(files["llama"], "llama")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_seq_mesh(device="cpu")
        with pytest.raises(AssertionError):  # T past the context
            ring_prefill(model.spec, model.params,
                         torch.ones((1, 65), dtype=torch.int64), mesh)
        with pytest.raises(ValueError):  # a mesh of another size
            make_seq_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
