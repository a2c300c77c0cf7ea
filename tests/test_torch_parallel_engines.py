"""The port's engines under a mesh (serve.Engine(mesh=),
paged.PagedEngine(mesh=), the speculative engines' `mesh`), mirroring
tests/test_paged.py:430-470 and tests/test_speculative.py:485-530 and
adding the dense Engine. One gloo world of 4 ranks on the CPU
(tests/torch_parallel_worlds.engines_world) runs a TP=4 and a DP x TP
2x2 mesh over a tiny LLaMA (Q4_0, 256 wide, 4 heads of 64) with a
1-layer draft. Every rank returns the same texts, and the greedy texts
equal the unsharded port engine's and the JAX package's engine on its
virtual mesh of the same shape. Under DP x TP a dense cache holds the
rank's `data` block of the slots, as the JAX package's does. Under a mesh the multi-step blocks run
eagerly, counted in `forward.EAGER_UNDER_MESH` on the card only."""

import jax.numpy as jnp
import pytest
import torch

import llm_tpu.loader as jloader
import llm_tpu.paged as jpaged
import llm_tpu.parallel as jpar
import llm_tpu.serve as jserve
import llm_tpu.speculative as jspec
import torch_parallel_worlds as worlds
from llm_tpu.ggml.types import GgmlType
from llm_tpu.samplers import DeterministicSampler as JDeterministic
from llm_tpu_torch.ops.sampling import DeviceSampler
from llm_tpu_torch.paged import PagedEngine
from llm_tpu_torch.parallel import launch
from llm_tpu_torch.samplers import DeterministicSampler
from llm_tpu_torch.serve import Engine, GenerationRequest
from llm_tpu_torch.speculative import PagedSpeculativeEngine, SpeculativeEngine
from llm_tpu_torch.testing import make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

WIDE = dict(n_embd=256, n_head=4)
SPEC_PROMPTS = ([2, 3], [9, 4, 5])


@pytest.fixture(autouse=True)
def wait_reference_steps(monkeypatch):
    """The reference's PagedEngine.step may hand a zero-copy page table
    that it clears before the dispatch reads it: wait on its step, on the
    reference side only (as tests/test_torch_paged.py does)."""
    step = jpaged.paged_step

    def waited(*a, **kw):
        out = step(*a, **kw)
        jnp.asarray(out[0]).block_until_ready()
        return out

    monkeypatch.setattr(jpaged, "paged_step", waited)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_par_engines")
    files = {"llama": str(d / "llama.bin"), "draft": str(d / "draft.bin")}
    make_tiny_file("llama", files["llama"], GgmlType.Q4_0, **WIDE)
    make_tiny_file("llama", files["draft"], GgmlType.Q4_0, seed=7,
                   n_layer=1, **WIDE)
    results = launch.spawn(worlds.engines_world, 4, "gloo", d / "store",
                           timeout=300, args=(files,))
    return files, results


@pytest.fixture(scope="module")
def models(world):
    files, _ = world
    t = (worlds.load(files["llama"], "llama"),
         worlds.load(files["draft"], "llama"))
    j = tuple(jloader.load(files[k], "llama",
                           params=jloader.ModelParameters(context_size=64))
              for k in ("llama", "draft"))
    return t, j


def _texts(t):
    return [t[i] for i in sorted(t)]


def _greedy(prompts, sampler, n=8):
    return [GenerationRequest(prompt=p, max_tokens=n, sampler=sampler())
            for p in prompts]


def _jgreedy(prompts, n=8):
    return [jserve.GenerationRequest(prompt=p, max_tokens=n,
                                     sampler=JDeterministic())
            for p in prompts]


KEYS = ["dense", "dense_dp_tp", "dense_multi", "paged", "paged_int8",
        "seeded", "spec", "paged_spec", "dense_multi_dp_tp",
        "paged_spec_dp_tp"]
MESHES = {"dense": (1, 4), "dense_dp_tp": (2, 2)}


@pytest.mark.parametrize("key", KEYS)
def test_every_rank_same_texts(world, key):
    _, res = world
    for r in range(1, 4):
        assert res[r][key] == res[0][key]


@pytest.mark.parametrize("key", ["dense", "dense_dp_tp"])
def test_dense_engine_mesh_matches_single_device(world, models, key):
    _, res = world
    (tm, _), (jm, _) = models
    ref = _texts(Engine(tm, max_streams=2, kv_dtype=torch.float32)
                 .generate_all(_greedy(worlds.PROMPTS, DeterministicSampler)))
    assert res[0][key] == ref
    data, model = MESHES[key]
    mesh = jpar.make_mesh(jpar.MeshConfig(data=data, model=model))
    with mesh:
        j = jserve.Engine(jm, max_streams=2, kv_dtype=jnp.float32, mesh=mesh)
        assert _texts(j.generate_all(_jgreedy(worlds.PROMPTS))) == ref


def test_dense_engine_splits_slots_over_data(world, models):
    """Under DP x TP 2x2 a rank's dense cache holds its `data` block of
    the slots and its `model` half of the kv heads, as the JAX package's
    shard_cache(batched=True) gives each device."""
    _, res = world
    (tm, _), (jm, _) = models
    L, Hkv = tm.spec.n_layer, tm.spec.n_head_kv
    shape = res[0]["dense_dp_tp_cache_k"]
    assert shape[:3] == (L, 1, Hkv // 2)
    mesh = jpar.make_mesh(jpar.MeshConfig(data=2, model=2))
    with mesh:
        j = jserve.Engine(jm, max_streams=2, kv_dtype=jnp.float32, mesh=mesh)
    local = {tuple(s.data.shape) for s in j.cache.k.addressable_shards}
    assert local == {shape}


def test_multi_step_runs_eagerly_and_counts_only_on_card(world, models):
    """Blocks of 4 on-device greedy steps under TP=4 give the unsharded
    engine's blocks' texts."""
    _, res = world
    (tm, _), _ = models
    reqs = [GenerationRequest(prompt=p, max_tokens=8,
                              device_sampler=DeviceSampler.greedy())
            for p in worlds.PROMPTS]
    ref = _texts(Engine(tm, max_streams=2, kv_dtype=torch.float32)
                 .generate_all(reqs, n_steps=4))
    assert res[0]["dense_multi"] == ref
    assert res[0]["eager_cpu"] == 0  # the CPU never captures


def test_multi_step_dp_tp_matches_single_device(world, models):
    """Blocks of 4 on-device greedy steps under DP x TP 2x2, each `data`
    row decoding its slot, give the unsharded engine's texts."""
    _, res = world
    (tm, _), _ = models
    reqs = [GenerationRequest(prompt=p, max_tokens=8,
                              device_sampler=DeviceSampler.greedy())
            for p in worlds.PROMPTS]
    ref = _texts(Engine(tm, max_streams=2, kv_dtype=torch.float32)
                 .generate_all(reqs, n_steps=4))
    assert res[0]["dense_multi_dp_tp"] == ref


def test_paged_engine_tp_mesh_matches_single_device(world, models):
    """Paged serving over a TP mesh: the pool holds each rank's kv heads,
    the weights are Megatron-sharded; token for token the meshless
    engine's and the reference's."""
    _, res = world
    (tm, _), (jm, _) = models
    ref = _texts(PagedEngine(tm, max_streams=2, page_size=16,
                             kv_dtype=torch.float32).generate_all(
        _greedy(worlds.PROMPTS, DeterministicSampler)))
    assert res[0]["paged"] == ref
    mesh = jpar.make_mesh(jpar.MeshConfig(data=1, model=4))
    with mesh:
        j = jpaged.PagedEngine(jm, max_streams=2, page_size=16,
                               kv_dtype=jnp.float32, mesh=mesh)
        assert _texts(j.generate_all(_jgreedy(worlds.PROMPTS))) == ref


def test_paged_engine_tp_mesh_int8(world, models):
    _, res = world
    (tm, _), (jm, _) = models
    ref = _texts(PagedEngine(tm, max_streams=1, page_size=16,
                             kv_dtype="int8").generate_all(
        _greedy([[2, 3]], DeterministicSampler)))
    assert res[0]["paged_int8"] == ref
    # [L, n_pages, H_kv / 4, page, D]: the rank's own heads
    assert res[0]["pool_k"][2] == 1 and res[0]["pool_k"][4] == 64
    mesh = jpar.make_mesh(jpar.MeshConfig(data=1, model=4))
    with mesh:
        j = jpaged.PagedEngine(jm, max_streams=1, page_size=16,
                               kv_dtype="int8", mesh=mesh)
        assert _texts(j.generate_all(_jgreedy([[2, 3]]))) == ref


def test_seeded_samplers_identical_on_every_rank(world):
    """The logits are gathered whole on every rank, so each rank's seeded
    sampler chain draws the same tokens."""
    _, res = world
    assert len({tuple(r["seeded"]) for r in res}) == 1


def test_speculative_engine_tp_mesh_matches_single_device(world, models):
    """Speculative serving under a DP x TP mesh: target and draft both
    shard; greedy output equals the unsharded engine's."""
    _, res = world
    (tm, td), (jm, jd) = models
    base = SpeculativeEngine(tm, td, k=3, max_streams=2,
                             kv_dtype=torch.float32, n_batch=8)
    refs = _texts(base.generate_all(
        [GenerationRequest(prompt=p, max_tokens=10) for p in SPEC_PROMPTS]))
    assert res[0]["spec"] == refs
    assert res[0]["spec_drafted"] > 0
    # the draft's cache holds the rank's slot and half of the draft's kv
    # heads
    assert res[0]["spec_d_cache_k"][1:3] == (1, 2)
    mesh = jpar.make_mesh(jpar.MeshConfig(data=2, model=2))
    j = jspec.SpeculativeEngine(jm, jd, k=3, max_streams=2,
                                kv_dtype=jnp.float32, n_batch=8, mesh=mesh)
    got = _texts(j.generate_all(
        [jserve.GenerationRequest(prompt=p, max_tokens=10)
         for p in SPEC_PROMPTS]))
    assert got == refs


def test_paged_speculative_engine_tp_mesh(world, models):
    _, res = world
    (tm, td), (jm, jd) = models
    ref = _texts(PagedSpeculativeEngine(
        tm, td, k=3, max_streams=1, page_size=16,
        kv_dtype=torch.float32).generate_all(
        [GenerationRequest(prompt=[2, 3], max_tokens=10)]))
    assert res[0]["paged_spec"] == ref
    mesh = jpar.make_mesh(jpar.MeshConfig(data=1, model=4))
    j = jspec.PagedSpeculativeEngine(jm, jd, k=3, max_streams=1,
                                     page_size=16, kv_dtype=jnp.float32,
                                     mesh=mesh)
    assert _texts(j.generate_all(
        [jserve.GenerationRequest(prompt=[2, 3], max_tokens=10)])) == ref


def test_paged_speculative_engine_dp_tp_mesh(world, models):
    """The paged speculative engine under DP x TP 2x2: the pool is whole
    along `data`, the draft's dense cache holds the rank's slot."""
    _, res = world
    (tm, td), (jm, jd) = models
    reqs = [GenerationRequest(prompt=p, max_tokens=10) for p in SPEC_PROMPTS]
    ref = _texts(PagedSpeculativeEngine(
        tm, td, k=3, max_streams=2, page_size=16,
        kv_dtype=torch.float32).generate_all(reqs))
    assert res[0]["paged_spec_dp_tp"] == ref
    assert res[0]["paged_spec_dp_tp_d_cache_k"][1:3] == (1, 2)
    mesh = jpar.make_mesh(jpar.MeshConfig(data=2, model=2))
    j = jspec.PagedSpeculativeEngine(jm, jd, k=3, max_streams=2,
                                     page_size=16, kv_dtype=jnp.float32,
                                     mesh=mesh)
    assert _texts(j.generate_all(
        [jserve.GenerationRequest(prompt=p, max_tokens=10)
         for p in SPEC_PROMPTS])) == ref
