"""The port's tensor and data parallelism (llm_tpu_torch.parallel.sharding
and the sharded forward), mirroring tests/test_sharding.py. One gloo world
of 4 ranks on the CPU (tests/torch_parallel_worlds.sharding_world) runs a
TP=4 mesh and a DP x TP 2x2 mesh on a tiny LLaMA (Q4_0, 256 wide, 4 heads
of 64), and all seven architectures at model=2. Each result is held
against the JAX package's sharded forward on its virtual mesh of the same
shape and against the unsharded forward, at rtol = atol = 1e-4 as the
reference's tests; every rank's logits are the same bytes. The planes of
the 7B geometry shard fully, by the unit rule (`_k_ok`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.loader as jloader
import llm_tpu.models.forward as jfwd
import llm_tpu.parallel as jpar
import llm_tpu_torch.models.forward as tfwd
import torch_parallel_worlds as worlds
from llm_tpu.ggml.quant import quantize
from llm_tpu.ggml.types import GgmlType
from llm_tpu_torch.ops.packing import pack_ggml
from llm_tpu_torch.parallel import launch
from llm_tpu_torch.parallel.sharding import (
    MeshConfig,
    _cols,
    _k_ok,
    _rows,
    make_mesh,
)
from llm_tpu_torch.testing import make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
WIDE = dict(n_embd=256, n_head=4)
ARCHS = {"llama": GgmlType.Q4_0, "gpt2": GgmlType.Q8_0,
         "gptj": GgmlType.Q4_0, "gptneox": GgmlType.Q5_1,
         "bloom": GgmlType.Q4_0, "mpt": GgmlType.Q4_K,
         "falcon": GgmlType.Q4_0}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharding")
    files = {"llama": str(d / "llama.bin"), "archs": {}}
    make_tiny_file("llama", files["llama"], GgmlType.Q4_0, **WIDE)
    for arch, et in ARCHS.items():
        files["archs"][arch] = str(d / f"{arch}_arch.bin")
        make_tiny_file(arch, files["archs"][arch], et, **WIDE)
    results = launch.spawn(worlds.sharding_world, 4, "gloo", d / "store",
                           timeout=300, args=(files,))
    return files, results


def _port(path, arch):
    return worlds.load(path, arch)


def _jload(path, arch):
    return jloader.load(path, arch,
                        params=jloader.ModelParameters(context_size=64))


def _t_unsharded(m, ids=worlds.IDS):
    cache = tfwd.init_cache(m.spec, torch.float32)
    lg, _, _ = tfwd.forward_step(m.spec, m.params, torch.tensor(ids), 0,
                                 cache)
    ld, _, _ = tfwd.forward_step(m.spec, m.params, torch.tensor([11]),
                                 len(ids), cache)
    return lg.numpy(), ld.numpy()


def _j_sharded(jm, data, model, ids=worlds.IDS):
    mesh = jpar.make_mesh(jpar.MeshConfig(data=data, model=model))
    params = jpar.shard_params(jm.params, mesh)
    cache = jpar.shard_cache(jfwd.init_cache(jm.spec, jnp.float32), mesh)
    with mesh:
        lg, _, cache = jfwd.forward_step(jm.spec, params,
                                         jnp.asarray(ids, jnp.int32),
                                         jnp.int32(0), cache)
        ld, _, _ = jfwd.forward_step(jm.spec, params,
                                     jnp.asarray([11], jnp.int32),
                                     jnp.int32(len(ids)), cache)
    return np.asarray(lg), np.asarray(ld)


def test_eight_virtual_devices_for_the_reference():
    assert len(jax.devices()) == 8


def test_ranks_row_major_and_logits_identical(world):
    _, res = world
    for r, out in enumerate(res):
        tp4, dp_tp = out["coords"]
        assert tp4 == {"data": 0, "model": r}
        assert dp_tp == {"data": r // 2, "model": r % 2}
        assert out["tp4"].tobytes() == res[0]["tp4"].tobytes()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(MeshConfig(data=1, model=2), device="cpu")


def test_tp_sharded_forward_matches_single_device(world):
    files, res = world
    ref = _t_unsharded(_port(files["llama"], "llama"))[0]
    np.testing.assert_allclose(res[0]["tp4"], ref, **TOL)
    j, _ = _j_sharded(_jload(files["llama"], "llama"), 1, 4)
    np.testing.assert_allclose(res[0]["tp4"], j, **TOL)


def test_dp_tp_batched_decode(world):
    files, res = world
    # rows of data index d come from ranks 2d and 2d + 1 (equal bytes)
    assert res[0]["dp_tp"].tobytes() == res[1]["dp_tp"].tobytes()
    assert res[2]["dp_tp"].tobytes() == res[3]["dp_tp"].tobytes()
    logits = np.concatenate([res[0]["dp_tp"], res[2]["dp_tp"]])
    m = _port(files["llama"], "llama")
    assert logits.shape == (4, 3, m.spec.n_vocab)
    assert res[0]["dp_tp_cache_k"] == (2, 2, 2, 64, 64)  # [L, B/2, H/2..]
    # stream 2 equals an independent single-stream run
    ref = _t_unsharded(m, worlds.BATCH_IDS[2])[0]
    np.testing.assert_allclose(logits[2], ref, **TOL)

    jm = _jload(files["llama"], "llama")
    mesh = jpar.make_mesh(jpar.MeshConfig(data=2, model=2))
    params = jpar.shard_params(jm.params, mesh)
    cache = jpar.shard_cache(jfwd.init_cache_batched(jm.spec, 4, jnp.float32),
                             mesh, batched=True)
    with mesh:
        jl, _, _ = jpar.batched_forward_step(
            jm.spec, params, jnp.asarray(worlds.BATCH_IDS, jnp.int32),
            jnp.zeros(4, jnp.int32), cache)
    np.testing.assert_allclose(logits, np.asarray(jl), **TOL)


def test_params_actually_sharded_not_replicated(world):
    """A silent fall back to whole weights would still pass every
    equality test: each rank's q|k|v hold a quarter of the columns, wo and
    its scales a quarter of the rows, and the cache a quarter of the
    heads."""
    _, res = world
    lay = res[1]["tp4_layout"]
    assert lay["attn"] and lay["wo_split"] and lay["ffn"] and lay["vocab"]
    assert lay["qkv_r"] == [64, 64, 64]  # 256 / 4 each
    assert lay["wo_k"] == 64
    assert lay["wo_lo"] == (2, 64 // 8, 256)  # [L, K/8 words, R]
    assert lay["wo_scale"] == (2, 64 // 64, 256)  # two f16 groups a word
    assert res[1]["cache_k"] == (2, 1, 1, 64, 64)


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_real_dim_planes_shard_fully(parts):
    """A 7B-geometry plane (4096 x 4096 Q4_0) splits into `parts` equal
    shards on both the R (columns) and K (rows) rules, each bit-equal to
    the matching slice of the whole plane."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4096, 4096)).astype(np.float32)
    qt = pack_ggml(GgmlType.Q4_0, quantize(GgmlType.Q4_0, w), (4096, 4096))
    n = 4096 // parts
    for i in (0, parts - 1):
        rc = _cols(qt, i * n, (i + 1) * n)
        assert rc.r == n and rc.lo.shape == (512, n)
        assert torch.equal(rc.lo, qt.lo[:, i * n:(i + 1) * n])
        assert torch.equal(rc.scale, qt.scale[:, i * n:(i + 1) * n])
        assert _k_ok(qt, n)
        kc = _rows(qt, i * n, (i + 1) * n)
        assert kc.k == n and kc.lo.shape == (n // 8, 4096)
        assert kc.scale.shape == (n // 64, 4096)
        assert torch.equal(kc.lo, qt.lo[i * n // 8:(i + 1) * n // 8])


def test_7b_down_rows_by_format():
    """down's rows at 7B (K = 11008) over model = 2 are 5504: whole Q4_0
    blocks (and the kernel's 64-row stages), not whole Q4_K super-blocks,
    so a Q4_K FFN stays whole."""
    q4 = pack_ggml(GgmlType.Q4_0,
                   quantize(GgmlType.Q4_0,
                            np.ones((128, 11008), np.float32)), (11008, 128))
    assert _k_ok(q4, 5504)
    assert _rows(q4, 5504, 11008).k == 5504
    from llm_tpu_torch.testing import _random_kquant

    raw = _random_kquant(np.random.default_rng(0), GgmlType.Q4_K,
                         128 * 11008)
    qk = pack_ggml(GgmlType.Q4_K, raw, (11008, 128))
    assert not _k_ok(qk, 5504)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_archs_model2(world, arch):
    """Each architecture at model = 2: the prompt's logits and a decode
    step equal the unsharded forward's and the JAX package's sharded
    forward (2 ranks of its virtual mesh). MPT and BLOOM hold the ALiBi
    slopes of the rank's heads; Falcon-7B's single kv head keeps its
    attention whole; MPT's Q4_K wo rows (128) are not whole super-blocks,
    so its heads are gathered before a whole wo."""
    files, res = world
    path = files["archs"][arch]
    lg, ld, lay = res[0]["archs"][arch]
    for r in (1, 2, 3):
        assert res[r]["archs"][arch][0].tobytes() == lg.tobytes()
    ref_lg, ref_ld = _t_unsharded(_port(path, arch))
    np.testing.assert_allclose(lg, ref_lg, **TOL)
    np.testing.assert_allclose(ld, ref_ld, **TOL)
    j_lg, j_ld = _j_sharded(_jload(path, arch), 1, 2)
    np.testing.assert_allclose(lg, j_lg, **TOL)
    np.testing.assert_allclose(ld, j_ld, **TOL)
    assert lay["attn"] == (arch != "falcon")
    assert lay["wo_split"] == (arch not in ("falcon", "mpt"))
    assert lay["ffn"]
    # MPT's head, and the tiny GPT-2's, is tied to the whole embedding
    assert lay["vocab"] == (arch not in ("mpt", "gpt2"))
