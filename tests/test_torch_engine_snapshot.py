"""The port's engine checkpoints (llm_tpu_torch.engine_snapshot) against
the JAX package's (llm_tpu.engine_snapshot), mirroring the 13 single-host
tests of tests/test_engine_snapshot.py on a tiny LLaMA (f32, context 64):
an engine checkpointed mid-flight (a stream mid-prefill, one pending, a
stateful mirostat chain with its RNG, logprobs) and restored in a fresh
engine gives exactly the uninterrupted run's tokens, text, finish reasons
and logprobs, for the dense Engine, the PagedEngine (int8 pool, prefix
cache) and the four speculative engines; page tables, allocator, prefix
cache and its logits rows, the draft cache, the acceptance counters, the
device loop's generator and mirostat mu survive; malformed, mismatched
and custom-sampler cases are refused and a refused restore leaves the
engine as it was.

Across the packages (the file format is the reference's): a reference
file restores in the port and its tokens equal the reference's restored
run (a dense bf16 engine and a paged int8 one); a port file restores in
the reference the same way; a file that carries the reference's
device-loop PRNG key is refused by name."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import engine_snapshot as jsnap
from llm_tpu import samplers as JS
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops.sampling import DeviceSampler as JDeviceSampler
from llm_tpu.paged import PagedEngine as JPagedEngine
from llm_tpu.serve import Engine as JEngine
from llm_tpu.serve import GenerationRequest as JRequest
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import samplers as S
from llm_tpu_torch.engine_snapshot import read_engine, write_engine
from llm_tpu_torch.ops.sampling import DeviceSampler
from llm_tpu_torch.paged import PagedEngine
from llm_tpu_torch.serve import Engine, GenerationRequest
from llm_tpu_torch.session import SnapshotError
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

CTX = 64


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_esnap")
    model, draft = d / "llama.bin", d / "draft.bin"
    make_tiny_file("llama", model)
    make_tiny_file("llama", draft, seed=7, n_layer=1)
    return model, draft


@pytest.fixture(scope="module")
def model(paths):
    return tloader.load(paths[0], "llama",
                        params=tloader.ModelParameters(context_size=CTX),
                        device="cpu")


@pytest.fixture(scope="module")
def draft(paths):
    return tloader.load(paths[1], "llama",
                        params=tloader.ModelParameters(context_size=CTX),
                        device="cpu")


@pytest.fixture(scope="module")
def jmodel(paths):
    return j_load(paths[0], "llama",
                  params=JModelParameters(context_size=CTX))


def _finished(engine):
    return {
        rid: (list(s.tokens), "".join(s.text), s.finish_reason)
        for rid, s in engine.finished.items()
    }


def _run_to_completion(engine, max_iters=200):
    for _ in range(max_iters):
        if not engine.has_work():
            return
        engine.step()
    raise AssertionError("engine did not drain")


LONG = "".join(f"<t{i}>" for i in range(2, 22))


def _requests(req=GenerationRequest, samplers=S):
    """Stream 0 deterministic with logprobs; stream 1 a stateful
    stochastic chain (mirostat mu and the RNG must survive); stream 2 a
    long prompt, mid-prefill at the checkpoint (n_batch 4); stream 3 still
    pending."""
    return [
        req(prompt="<t2><t3>", max_tokens=8,
            sampler=samplers.DeterministicSampler(), logprobs=2),
        req(prompt="<t9><t4>", max_tokens=8, seed=7,
            sampler=samplers.SamplerChain(
                [samplers.TopK(k=5), samplers.Temperature(temperature=0.7)],
                samplers.Mirostat2(tau=3.0, eta=0.3))),
        req(prompt=LONG, max_tokens=5,
            sampler=samplers.DeterministicSampler()),
        req(prompt="<t7><t8>", max_tokens=6,
            sampler=samplers.DeterministicSampler()),
    ]


def _checkpoint_equivalence(make_engine, tmp_path, steps=3):
    a = make_engine()
    for r in _requests():
        a.submit(r)
    for _ in range(steps):
        a.step()
    path = tmp_path / "engine.ckpt"
    write_engine(a, path)
    b = make_engine()
    read_engine(b, path)
    assert b._next_id == a._next_id
    _run_to_completion(a)
    _run_to_completion(b)
    assert _finished(b) == _finished(a)
    la = [s.logprob_data for s in a.finished.values() if s.logprob_data]
    lb = [s.logprob_data for s in b.finished.values() if s.logprob_data]
    assert la == lb and la


def test_dense_engine_roundtrip(model, tmp_path):
    _checkpoint_equivalence(
        lambda: Engine(model, max_streams=3, kv_dtype=torch.float32,
                       n_batch=4), tmp_path)


def test_paged_engine_roundtrip(model, tmp_path):
    _checkpoint_equivalence(
        lambda: PagedEngine(model, max_streams=3, page_size=16,
                            kv_dtype="int8", n_batch=4, prefix_cache=True),
        tmp_path)


def test_paged_state_restored_exactly(model, tmp_path):
    eng = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                      n_batch=4, prefix_cache=True)
    for r in _requests()[:2]:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    path = tmp_path / "paged.ckpt"
    write_engine(eng, path)
    fresh = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                        n_batch=4, prefix_cache=True)
    read_engine(fresh, path)
    assert np.array_equal(fresh.tables, eng.tables)
    assert fresh.stream_pages == eng.stream_pages
    assert fresh.allocator.free == eng.allocator.free
    assert fresh.prefix_cache.by_key == eng.prefix_cache.by_key
    assert fresh.prefix_cache.refs == eng.prefix_cache.refs
    assert torch.equal(fresh.pool.k, eng.pool.k)
    assert torch.equal(fresh.pool.k_scale, eng.pool.k_scale)


def _aligned_req():
    # 15 tokens + BOS = 16 = exactly one page of 16
    return GenerationRequest(prompt="".join(f"<t{i}>" for i in range(2, 17)),
                             max_tokens=2, sampler=S.DeterministicSampler())


def test_prefix_logits_cache_roundtrip(model, tmp_path):
    """The exact-hit logits rows survive, and a restore of a file with no
    prefix state clears stale rows."""
    eng = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                      n_batch=16, prefix_cache=True)
    eng.generate_all([_aligned_req()])
    assert len(eng.prefix_cache.logits_by_key) == 1
    path = tmp_path / "pl.ckpt"
    write_engine(eng, path)
    fresh = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                        n_batch=16, prefix_cache=True)
    read_engine(fresh, path)
    assert set(fresh.prefix_cache.logits_by_key) == \
        set(eng.prefix_cache.logits_by_key)
    for k, row in eng.prefix_cache.logits_by_key.items():
        assert np.array_equal(fresh.prefix_cache.logits_by_key[k], row)
    calls = []  # the restored engine takes the exact-hit path
    orig = fresh._prefill_chunk
    fresh._prefill_chunk = lambda s, sl: (calls.append(1), orig(s, sl))
    out = fresh.generate_all([_aligned_req()])
    assert calls == []
    assert sorted(out.values()) == \
        sorted(eng.generate_all([_aligned_req()]).values())

    plain = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                        n_batch=16)
    write_engine(plain, path2 := tmp_path / "noprefix.ckpt")
    stale = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                        n_batch=16, prefix_cache=True)
    stale.generate_all([_aligned_req()])
    assert stale.prefix_cache.logits_by_key
    read_engine(stale, path2)
    assert not stale.prefix_cache.logits_by_key
    assert not stale.prefix_cache.by_key


def test_geometry_mismatch_rejected(model, tmp_path):
    eng = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8")
    path = tmp_path / "geom.ckpt"
    write_engine(eng, path)
    with pytest.raises(SnapshotError, match="page geometry"):
        read_engine(PagedEngine(model, max_streams=2, page_size=32,
                                kv_dtype="int8"), path)
    with pytest.raises(SnapshotError, match="max_streams"):
        read_engine(PagedEngine(model, max_streams=4, page_size=16,
                                kv_dtype="int8"), path)
    with pytest.raises(SnapshotError, match="checkpoint is for"):
        read_engine(Engine(model, max_streams=2), path)
    with pytest.raises(SnapshotError, match="KV dtype"):
        read_engine(PagedEngine(model, max_streams=2, page_size=16,
                                kv_dtype=torch.float32), path)
    # a dense cache of another dtype is refused by its array's dtype
    dense = Engine(model, max_streams=2, kv_dtype=torch.float32)
    write_engine(dense, path3 := tmp_path / "dense.ckpt")
    with pytest.raises(SnapshotError, match="cache.k: checkpoint float32"):
        read_engine(Engine(model, max_streams=2, kv_dtype=torch.bfloat16),
                    path3)
    # not a checkpoint, and a truncated one
    (bad := tmp_path / "bad.ckpt").write_bytes(b"nope")
    with pytest.raises(SnapshotError, match="not an engine checkpoint"):
        read_engine(dense, bad)
    data = path3.read_bytes()
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(SnapshotError):
        read_engine(dense, bad)


def test_on_token_reattached(model, tmp_path):
    eng = Engine(model, max_streams=2, kv_dtype=torch.float32)
    eng.submit(GenerationRequest(prompt="<t2><t3>", max_tokens=6,
                                 sampler=S.DeterministicSampler()))
    eng.step()
    path = tmp_path / "cb.ckpt"
    write_engine(eng, path)
    got = []
    fresh = Engine(model, max_streams=2, kv_dtype=torch.float32)
    read_engine(fresh, path, on_token=lambda rid, txt: got.append((rid, txt)))
    _run_to_completion(fresh)
    text = "".join(fresh.finished[0].text)
    assert "".join(t for _, t in got) != ""
    assert text.endswith("".join(t for _, t in got))


def test_loop_gen_survives_for_stochastic_step_multi(model, tmp_path):
    """The block decode's generator is engine state: a restored engine
    draws what the original would have."""
    def make():
        return Engine(model, max_streams=2, kv_dtype=torch.float32,
                      n_batch=4)

    def submit(e):
        for p in ("<t2><t3>", "<t9><t4>"):
            e.submit(GenerationRequest(
                prompt=p, max_tokens=12,
                device_sampler=DeviceSampler.top_k_temperature(5, 0.7)))

    a = make()
    submit(a)
    a.step_multi(4)  # advances the generator past its seed
    assert a._loop_gen is not None
    path = tmp_path / "lk.ckpt"
    write_engine(a, path)
    b = make()
    read_engine(b, path)
    assert torch.equal(b._loop_gen.get_state(), a._loop_gen.get_state())
    while a.has_work():
        a.step_multi(4)
    while b.has_work():
        b.step_multi(4)
    assert _finished(b) == _finished(a)


def test_speculative_engine_roundtrip(model, draft, tmp_path):
    """The draft's cache and the acceptance counters ride the file; a
    speculative file does not restore into a plain Engine; the sampled
    engine's draws continue from the restored generator."""
    from llm_tpu_torch.speculative import (
        SampledSpeculativeEngine,
        SpeculativeEngine,
    )

    def make():
        return SpeculativeEngine(model, draft, k=3, max_streams=2,
                                 kv_dtype=torch.float32, n_batch=4)

    a = make()
    for p in ("<t2><t3>", "<t9><t4>"):
        a.submit(GenerationRequest(prompt=p, max_tokens=10))
    for _ in range(3):
        a.step()
    path = tmp_path / "spec.ckpt"
    write_engine(a, path)
    b = make()
    read_engine(b, path)
    assert (b.accepted, b.drafted) == (a.accepted, a.drafted)
    assert torch.equal(b.d_cache.k, a.d_cache.k)
    _run_to_completion(a)
    _run_to_completion(b)
    assert _finished(b) == _finished(a)
    with pytest.raises(SnapshotError, match="checkpoint is for"):
        read_engine(Engine(model, max_streams=2, kv_dtype=torch.float32,
                           n_batch=4), path)

    def make_s():
        return SampledSpeculativeEngine(model, draft, k=3, max_streams=2,
                                        kv_dtype=torch.float32, n_batch=4)

    sa = make_s()
    for p in ("<t2><t3>", "<t9><t4>"):
        sa.submit(GenerationRequest(
            prompt=p, max_tokens=10,
            device_sampler=DeviceSampler.top_k_temperature(5, 0.7)))
    for _ in range(3):
        sa.step()
    spath = tmp_path / "sspec.ckpt"
    write_engine(sa, spath)
    sb = make_s()
    read_engine(sb, spath)
    _run_to_completion(sa)
    _run_to_completion(sb)
    assert _finished(sb) == _finished(sa)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_paged_speculative_engine_roundtrip(model, draft, tmp_path, sampled):
    """Both branches at once: the target's pool, tables and allocator, and
    the draft's dense cache."""
    from llm_tpu_torch.speculative import (
        PagedSampledSpeculativeEngine,
        PagedSpeculativeEngine,
    )

    cls = PagedSampledSpeculativeEngine if sampled else PagedSpeculativeEngine

    def make():
        return cls(model, draft, k=3, max_streams=2, kv_dtype="int8",
                   page_size=16, n_batch=4)

    dev = DeviceSampler.top_k_temperature(5, 0.7) if sampled else None
    a = make()
    for p in ("<t2><t3>", "<t9><t4>"):
        a.submit(GenerationRequest(prompt=p, max_tokens=10,
                                   device_sampler=dev))
    for _ in range(3):
        a.step()
    path = tmp_path / "pspec.ckpt"
    write_engine(a, path)
    b = make()
    read_engine(b, path)
    assert np.array_equal(b.tables, a.tables)
    _run_to_completion(a)
    _run_to_completion(b)
    assert _finished(b) == _finished(a)


def test_custom_sampler_rejected(model, tmp_path):
    class Weird:
        def sample(self, logits, prev, rng):
            return 2

    eng = Engine(model, max_streams=1, kv_dtype=torch.float32)
    eng.submit(GenerationRequest(prompt="<t2>", max_tokens=4,
                                 sampler=Weird()))
    eng.step()
    with pytest.raises(SnapshotError, match="not checkpointable"):
        write_engine(eng, tmp_path / "weird.ckpt")
    assert not (tmp_path / "weird.ckpt").exists()
    assert not list(tmp_path.iterdir())  # no temporary file left


def test_shadowing_sampler_dataclass_rejected(model, tmp_path):
    @dataclasses.dataclass
    class TopK:  # the name of samplers.TopK, other semantics
        k: int = 5

        def sample(self, logits, prev, rng):
            return 2

        def apply(self, logits, prev, rng):
            return logits

    eng = Engine(model, max_streams=1, kv_dtype=torch.float32)
    eng.submit(GenerationRequest(prompt="<t2>", max_tokens=4,
                                 sampler=TopK()))
    eng.step()
    with pytest.raises(SnapshotError, match="not checkpointable"):
        write_engine(eng, tmp_path / "shadow.ckpt")


def test_failed_restore_leaves_engine_intact(model, tmp_path):
    src = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                      n_batch=4, prefix_cache=True)
    src.submit(GenerationRequest(prompt="<t2><t3>" * 8, max_tokens=4,
                                 sampler=S.DeterministicSampler()))
    while src.has_work():
        src.step()
    path = tmp_path / "pfx.ckpt"
    write_engine(src, path)

    eng = PagedEngine(model, max_streams=2, page_size=16, kv_dtype="int8",
                      n_batch=4)  # no prefix cache
    free_before = list(eng.allocator.free)
    tables_before = eng.tables.copy()
    pool_before = eng.pool.k.clone()
    with pytest.raises(SnapshotError, match="prefix cache"):
        read_engine(eng, path)
    assert eng.allocator.free == free_before
    assert np.array_equal(eng.tables, tables_before)
    assert torch.equal(eng.pool.k, pool_before)
    out = eng.generate_all([GenerationRequest(
        prompt="<t5>", max_tokens=4, sampler=S.DeterministicSampler())])
    assert out[0]


def test_mirostat_mu_survives_checkpoint(model, tmp_path):
    engine = Engine(model, max_streams=2, kv_dtype=torch.float32)
    engine.submit(GenerationRequest(
        prompt=[2, 3], max_tokens=20,
        device_sampler=DeviceSampler(kind="sample", temperature=0.9,
                                     mirostat=2, mirostat_tau=4.0)))
    for _ in range(3):
        engine.step_multi(3)
    live = [s for s in engine.slots if s is not None]
    assert live and live[0].mirostat_mu is not None
    mu = live[0].mirostat_mu
    path = tmp_path / "miro.ckpt"
    write_engine(engine, path)
    fresh = Engine(model, max_streams=2, kv_dtype=torch.float32)
    read_engine(fresh, path)
    restored = [s for s in fresh.slots if s is not None]
    assert restored and restored[0].mirostat_mu == mu


# -- across the packages ------------------------------------------------------

CROSS = {
    "dense_bf16": (
        lambda m: JEngine(m, max_streams=3, kv_dtype=jnp.bfloat16, n_batch=4),
        lambda m: Engine(m, max_streams=3, kv_dtype=torch.bfloat16,
                         n_batch=4)),
    "paged_int8": (
        lambda m: JPagedEngine(m, max_streams=3, page_size=16,
                               kv_dtype="int8", n_batch=4, prefix_cache=True),
        lambda m: PagedEngine(m, max_streams=3, page_size=16,
                              kv_dtype="int8", n_batch=4, prefix_cache=True)),
}


@pytest.mark.parametrize("kind", list(CROSS))
def test_reference_file_restores_in_port(model, jmodel, tmp_path, kind):
    make_j, make_t = CROSS[kind]
    a = make_j(jmodel)
    for r in _requests(JRequest, JS):
        a.submit(r)
    for _ in range(3):
        a.step()
    path = tmp_path / "ref.ckpt"
    jsnap.write_engine(a, path)
    assert "loop_key" not in _header(path)

    want = make_j(jmodel)
    jsnap.read_engine(want, path)
    got = make_t(model)
    read_engine(got, path)
    assert got._next_id == want._next_id
    k_name = "pool.k" if kind.startswith("paged") else "cache.k"
    kv = got.pool.k if kind.startswith("paged") else got.cache.k
    jkv = want.pool.k if kind.startswith("paged") else want.cache.k
    assert _header(path)["arrays"][[a["name"] for a in _header(path)[
        "arrays"]].index(k_name)]["dtype"] == (
        "int8" if kind.startswith("paged") else "bfloat16")
    assert np.array_equal(kv.to(torch.float32).numpy(),
                          np.asarray(jkv, np.float32))
    _run_to_completion(want)
    _run_to_completion(got)
    assert _finished(got) == _finished(want)


@pytest.mark.parametrize("kind", list(CROSS))
def test_port_file_restores_in_reference(model, jmodel, tmp_path, kind):
    make_j, make_t = CROSS[kind]
    a = make_t(model)
    for r in _requests():
        a.submit(r)
    for _ in range(3):
        a.step()
    path = tmp_path / "port.ckpt"
    write_engine(a, path)
    b = make_j(jmodel)
    jsnap.read_engine(b, path)
    _run_to_completion(a)
    _run_to_completion(b)
    assert _finished(b) == _finished(a)


def test_foreign_loop_state_refused(model, jmodel, tmp_path):
    """The reference's engine after a stochastic block carries its PRNG
    key: the port refuses the file by the key's name and is untouched."""
    a = JEngine(jmodel, max_streams=2, kv_dtype=jnp.float32, n_batch=4)
    for p in ("<t2><t3>", "<t9><t4>"):
        a.submit(JRequest(prompt=p, max_tokens=12,
                          device_sampler=JDeviceSampler.top_k_temperature(
                              5, 0.7)))
    a.step_multi(4)
    path = tmp_path / "key.ckpt"
    jsnap.write_engine(a, path)
    assert "loop_key" in _header(path)
    eng = Engine(model, max_streams=2, kv_dtype=torch.float32, n_batch=4)
    with pytest.raises(SnapshotError, match="'loop_key'"):
        read_engine(eng, path)
    assert not eng.has_work() and eng._loop_gen is None


def _header(path) -> dict:
    import json
    import struct

    with open(path, "rb") as f:
        f.read(9)
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n))
