"""The port's multi-host engines (llm_tpu_torch.parallel.multihost:
MultiHostEngine, MultiHostPagedEngine) against the JAX package's engines,
mirroring tests/test_multihost.py (its two-process run is
tests/test_torch_multihost_serving.py's).

One gloo world of 4 ranks on the CPU (tests/torch_multihost_worlds.
engines_world) builds the (data, model) meshes (2, 2) and (4, 1) in turn
over the tiny LLaMA (f32, context 64). A host is a `model` row; host d
submits its own prompts (HOST_PROMPTS[d]), and its texts equal the JAX
package's Engine / PagedEngine on those prompts, run here as the
reference's tests run them: f32, bf16, int8 and int4 KV; host-sampled
and device-greedy blocks with penalties; mirostat beside a greedy
batchmate; logprobs; pool pressure and kv_oom; admission near the
context boundary. Added: every rank of a row returns the same texts,
request ids are data_index * 1_000_000 + k, the audited decode step,
block and paged step move no tensor byte over `data` (the control
all-gather's bytes are recorded apart), and LlmServer over the (2, 2)
rows, whose leaders serve HTTP and whose followers run their requests."""

import jax.numpy as jnp
import pytest

import llm_tpu.loader as jloader
import llm_tpu.paged as jpaged
import llm_tpu.serve as jserve
import torch_multihost_worlds as worlds
from llm_tpu.ops.sampling import DeviceSampler as JDeviceSampler
from llm_tpu.samplers import DeterministicSampler as JDeterministic
from llm_tpu.samplers import GreedySampler as JGreedy
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch.parallel import launch
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

MESHES = sorted(worlds.MESHES)


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
    d = tmp_path_factory.mktemp("torch_multihost")
    files = {"llama": str(d / "llama.bin")}
    make_tiny_file("llama", files["llama"])
    return launch.spawn(worlds.engines_world, 4, "gloo", d / "store",
                        timeout=300, args=(files,))


@pytest.fixture(scope="module")
def jmodel(world, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost_ref")
    make_tiny_file("llama", d / "llama.bin")
    return jloader.load(d / "llama.bin", "llama",
                        params=jloader.ModelParameters(context_size=64))


_REFS: dict = {}


def _ref(jmodel, key, make, reqs, n_steps=1):
    """The JAX engine's texts (in submission order), once per key."""
    if key not in _REFS:
        out = make().generate_all(reqs(), n_steps=n_steps)
        _REFS[key] = [out[i] for i in sorted(out)]
    return _REFS[key]


def _jdet(prompts, n=8):
    return lambda: [jserve.GenerationRequest(prompt=p, max_tokens=n,
                                             sampler=JDeterministic())
                    for p in prompts]


def _jgreedy(prompts, n=8):
    return lambda: [jserve.GenerationRequest(prompt=p, max_tokens=n,
                                             sampler=JGreedy())
                    for p in prompts]


def _ranks(world, mesh):
    """(rank, host, results) of every rank on `mesh`."""
    return [(r, res[mesh]["coords"]["data"], res[mesh])
            for r, res in enumerate(world)]


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_engine(world, jmodel, mesh):
    """Every host's texts (f32, interleaved chunked prefill) equal the
    JAX package's dense Engine on that host's prompts."""
    for _, host, res in _ranks(world, mesh):
        P = worlds.HOST_PROMPTS[host]
        ref = _ref(jmodel, ("dense", host), lambda: jserve.Engine(
            jmodel, max_streams=len(P), kv_dtype=jnp.float32), _jdet(P))
        assert res["dense"] == ref, host


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_of_a_row_same_texts(world, mesh):
    keys = [k for k in world[0][mesh] if k not in ("coords", "ids", "slots")
            and not k.startswith("audit")]
    rows: dict = {}
    for _, host, res in _ranks(world, mesh):
        rows.setdefault(host, []).append(res)
    for host, members in rows.items():
        assert len(members) == 4 // len(rows)
        for res in members[1:]:
            for k in keys:
                assert res[k] == members[0][k], (host, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_request_ids_and_rows(world, mesh):
    """Request ids are data_index * 1_000_000 + k; host d owns the slots
    [2d, 2d + 2) of the global batch, and its cache holds them over its
    kv heads."""
    d, m = worlds.MESHES[mesh]
    for _, host, res in _ranks(world, mesh):
        assert res["ids"] == [host * 1_000_000, host * 1_000_000 + 1]
        slots, row0, shape = res["slots"]
        assert (slots, row0) == (2, 2 * host)
        assert shape[1:3] == (2, 4 // m)


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_engine_int8(world, jmodel, mesh):
    ref = _ref(jmodel, "dense_int8", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype="int8"), _jdet([[2, 3]]))
    for _, _, res in _ranks(world, mesh):
        assert res["dense_int8"] == ref


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_step_multi(world, jmodel, mesh):
    """Coordinated on-device greedy blocks equal the JAX engine's greedy
    texts."""
    for _, host, res in _ranks(world, mesh):
        P = worlds.HOST_PROMPTS[host]
        ref = _ref(jmodel, ("greedy", host), lambda: jserve.Engine(
            jmodel, max_streams=2, kv_dtype=jnp.float32), _jgreedy(P))
        assert res["multi"] == ref, host
        assert res["multi_blocks"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_admission_near_context_boundary(world, jmodel, mesh):
    """A prefill chunk's n_batch-wide dummy row for a stream decoding near
    n_ctx writes nothing (write_mask)."""
    ref = _ref(jmodel, "boundary", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype=jnp.float32),
        _jgreedy([[2] * 41], 20))
    for _, _, res in _ranks(world, mesh):
        assert res["boundary_n_past"] >= 56
        assert [res["boundary"]] == ref


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged(world, jmodel, mesh):
    """Row-local bf16 page pools equal the JAX dense bf16 engine; a
    rank's pool holds 1 + 2 * 8 pages of its own kv heads."""
    d, m = worlds.MESHES[mesh]
    for _, host, res in _ranks(world, mesh):
        P = worlds.HOST_PROMPTS[host]
        ref = _ref(jmodel, ("bf16", host), lambda: jserve.Engine(
            jmodel, max_streams=2, kv_dtype=jnp.bfloat16), _jdet(P))
        assert res["paged"] == ref, host
        assert res["pool_k"][1:3] == (17, 4 // m)


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_quantized(world, jmodel, mesh, kv):
    ref = _ref(jmodel, ("paged", kv), lambda: jpaged.PagedEngine(
        jmodel, max_streams=1, kv_dtype=kv, n_batch=4, page_size=8),
        _jdet([[2, 3, 4]]))
    for _, _, res in _ranks(world, mesh):
        assert res[f"paged_{kv}"] == ref


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_kv_oom_retires(world, mesh):
    """A pool too small for the prompt retires the stream with kv_oom
    rather than stalling the world's lockstep."""
    for _, _, res in _ranks(world, mesh):
        assert res["kv_oom"] == "kv_oom"


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_step_multi(world, jmodel, mesh):
    for _, host, res in _ranks(world, mesh):
        P = worlds.HOST_PROMPTS[host]
        ref = _ref(jmodel, ("bf16_greedy9", host), lambda: jserve.Engine(
            jmodel, max_streams=2, kv_dtype=jnp.bfloat16), _jgreedy(P, 9))
        assert res["paged_multi"] == ref, host


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_step_multi_pool_pressure(world, jmodel, mesh):
    ref = _ref(jmodel, "pool_pressure", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype=jnp.bfloat16), _jgreedy([[2, 3]]))
    for _, _, res in _ranks(world, mesh):
        assert res["pool_pressure"] == ref


def _host_logprobs(jmodel, key, make):
    if key not in _REFS:
        eng = make()
        rid = eng.submit(jserve.GenerationRequest(
            prompt=[2, 3], max_tokens=6, logprobs=2, sampler=JGreedy()))
        while eng.has_work():
            eng.step()
        _REFS[key] = eng.finished[rid].logprob_data
    return _REFS[key]


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_step_multi_device_logprobs(world, jmodel, mesh):
    """Logprob requests ride the coordinated block: entries match the
    JAX engine's host-side record (tokens equal, logprobs within 1e-3,
    the same top-2)."""
    ref = _host_logprobs(jmodel, "logprobs", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype=jnp.float32))
    for _, _, res in _ranks(world, mesh):
        got = res["multi_logprobs"]
        assert len(got) == len(ref) == 6
        for h, d in zip(ref, got):
            assert h["token"] == d["token"]
            assert abs(h["logprob"] - d["logprob"]) < 1e-3
            assert set(h["top_logprobs"]) == set(d["top_logprobs"])


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_step_multi_logprobs(world, mesh):
    for _, _, res in _ranks(world, mesh):
        data = res["paged_multi_logprobs"]
        assert len(data) == 5
        for e in data:
            assert len(e["top_logprobs"]) == 2
            assert abs(max(e["top_logprobs"].values()) - e["logprob"]) < 1e-5


_PEN = dict(kind="greedy", repeat_penalty=1.4, penalty_last_n=8)


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_step_multi_penalties(world, jmodel, mesh):
    """Windowed penalties through the coordinated dense block equal the
    JAX engine's device-penalized greedy blocks."""
    ref = _ref(jmodel, "penalties", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype=jnp.float32),
        lambda: [jserve.GenerationRequest(
            prompt=[2, 3], max_tokens=10,
            device_sampler=JDeviceSampler(**_PEN))], n_steps=4)
    for _, _, res in _ranks(world, mesh):
        assert res["multi_penalties"] == ref


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_step_multi_penalties(world, jmodel, mesh):
    ref = _ref(jmodel, "paged_penalties", lambda: jpaged.PagedEngine(
        jmodel, max_streams=1, page_size=16, kv_dtype=jnp.float32),
        lambda: [jserve.GenerationRequest(
            prompt=[2, 3], max_tokens=10,
            device_sampler=JDeviceSampler(**_PEN))], n_steps=4)
    for _, _, res in _ranks(world, mesh):
        assert res["paged_multi_penalties"] == ref


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_step_multi_mirostat(world, jmodel, mesh):
    """A mirostat-2 stream rides the coordinated block (its mu carried and
    moved); its greedy batchmate equals the JAX engine's greedy text."""
    ref = _ref(jmodel, "greedy1", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype=jnp.float32), _jgreedy([[2, 3]]))
    for _, _, res in _ranks(world, mesh):
        greedy, miro, moved = res["multi_mirostat"]
        assert [greedy] == ref
        assert miro and moved


@pytest.mark.parametrize("mesh", MESHES)
def test_multihost_paged_step_multi_mirostat(world, jmodel, mesh):
    ref = _ref(jmodel, "greedy1_6", lambda: jserve.Engine(
        jmodel, max_streams=1, kv_dtype=jnp.float32), _jgreedy([[2, 3]], 6))
    for _, _, res in _ranks(world, mesh):
        greedy, miro = res["paged_multi_mirostat"]
        assert [greedy] == ref
        assert miro


@pytest.mark.parametrize("case", ["audit_decode", "audit_block",
                                  "audit_paged"])
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_zero_data_bytes(world, mesh, case):
    """The counterpart of the reference's zero-DCN audits: a decode step
    (dense, a block of 4, paged) moves no tensor byte over `data`; under
    `model` 2 the TP collectives run on `model`; the control all-gathers
    are recorded apart, on "control"."""
    d, m = worlds.MESHES[mesh]
    for _, _, res in _ranks(world, mesh):
        by = res[case]["by_axis"]
        assert by.get("data", 0) == 0 and by.get("mixed", 0) == 0, by
        assert by.get("control", 0) > 0
        assert (by.get("model", 0) > 0) == (m > 1), by
        control = [o for o in res[case]["ops"] if o[1] == "control"]
        assert control and all(o[0] == "all-gather" for o in control)


def test_rows_serve_http(world, jmodel):
    """LlmServer over the (2, 2) rows: the leaders (model index 0) bind
    addresses and answer their host's prompts at temperature 0 with the
    JAX engine's greedy texts; the followers bind none and finish the
    same requests; every loop exits once both leaders have stopped."""
    for rank, res in enumerate(world):
        h = res["rows_http"]
        host = res["dp_tp"]["coords"]["data"]
        assert h["loop"] == "_MultiHostEngineLoop"
        assert h["leader"] == (res["dp_tp"]["coords"]["model"] == 0)
        assert (h["address"] is not None) == h["leader"]
        assert not h["loop_alive"]
        P = worlds.HOST_PROMPTS[host]
        ref = _ref(jmodel, ("greedy", host), lambda: jserve.Engine(
            jmodel, max_streams=2, kv_dtype=jnp.float32), _jgreedy(P))
        if h["leader"]:
            assert h["texts"] == ref
        assert [h["finished"][k] for k in sorted(h["finished"])] == ref
