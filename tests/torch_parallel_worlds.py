"""Rank functions of the port's parallel tests (tests/test_torch_sharding.py,
test_torch_parallel_engines.py, test_torch_collectives_audit.py,
test_torch_pipeline.py, test_torch_ring.py). Each test module spawns one
gloo world on the CPU (`llm_tpu_torch.parallel.launch.spawn`, a `file://`
store under the test's tmp_path) that runs one of these functions; every
case's results come back to the parent as numpy arrays and plain values.
This module imports only torch and the port, so a rank starts quickly."""

from __future__ import annotations

import numpy as np
import torch

from llm_tpu_torch import loader as tloader
from llm_tpu_torch.models import forward as tfwd
from llm_tpu_torch.parallel import collectives_audit as audit
from llm_tpu_torch.parallel.sharding import (
    MeshConfig,
    batched_forward_step,
    make_mesh,
    shard_cache,
    shard_params,
)

CTX = 64
IDS = [3, 17, 5, 9]
BATCH_IDS = [[3, 17, 5], [9, 22, 1], [8, 40, 2], [7, 6, 11]]
PROMPTS = ["<t2><t3>", "<t9><t4><t5>"]


def load(path, arch, ctx=CTX):
    return tloader.load(path, arch,
                        params=tloader.ModelParameters(context_size=ctx),
                        device="cpu")


def _layout(p) -> dict:
    tp = p.tp
    L = p.layers
    out = {"attn": tp.attn, "wo_split": tp.wo_split, "ffn": tp.ffn,
           "vocab": tp.vocab, "n_head": tp.n_head, "n_head_kv": tp.n_head_kv}
    qkv = L.w_qkv
    if qkv is not None and getattr(qkv, "splits", None) is not None:
        out["qkv_r"] = [r for r, _ in qkv.splits]
        out["qkv_lo"] = tuple(qkv.lo.shape)
    wo = L.wo
    if hasattr(wo, "lo"):
        out["wo_k"], out["wo_lo"] = wo.k, tuple(wo.lo.shape)
        out["wo_scale"] = tuple(wo.scale.shape)
    return out


def sharding_world(rank, world, files):
    """TP=4 and DP x TP (2x2) on the tiny LLaMA, and all seven
    architectures at model=2 (on the 2x2 mesh)."""
    out = {}
    tp4 = make_mesh(MeshConfig(data=1, model=4), device="cpu")
    dp_tp = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    out["coords"] = (tp4.coords, dp_tp.coords)
    m = load(files["llama"], "llama")
    p = shard_params(m.params, tp4, m.spec)
    cache = shard_cache(tfwd.init_cache(m.spec, torch.float32), tp4)
    out["cache_k"] = tuple(cache.k.shape)
    lg, _, _ = tfwd.forward_step(m.spec, p, torch.tensor(IDS), 0, cache)
    out["tp4"] = lg.numpy()
    out["tp4_layout"] = _layout(p)

    p2 = shard_params(m.params, dp_tp, m.spec)
    c2 = shard_cache(tfwd.init_cache_batched(m.spec, 4, torch.float32), dp_tp,
                     batched=True)
    out["dp_tp_cache_k"] = tuple(c2.k.shape)
    lg2, _, _ = batched_forward_step(m.spec, p2, torch.tensor(BATCH_IDS),
                                     torch.zeros(4, dtype=torch.int32), c2)
    out["dp_tp"] = lg2.numpy()

    archs = {}
    for arch, path in files["archs"].items():
        a = load(path, arch)
        pa = shard_params(a.params, dp_tp, a.spec)
        ca = shard_cache(tfwd.init_cache(a.spec, torch.float32), dp_tp)
        la, _, _ = tfwd.forward_step(a.spec, pa, torch.tensor(IDS), 0, ca)
        # a decode step after the prompt: the cached-KV attention (K2's
        # plain version) over the rank's heads
        ld, _, _ = tfwd.forward_step(a.spec, pa, torch.tensor([11]),
                                     len(IDS), ca)
        archs[arch] = (la.numpy(), ld.numpy(), _layout(pa))
    out["archs"] = archs
    return out


def engines_world(rank, world, files):
    """The engines under a mesh, each on the requests of the reference's
    mesh tests; every rank returns its texts."""
    from llm_tpu_torch.ops.sampling import DeviceSampler
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.samplers import DeterministicSampler, default_samplers
    from llm_tpu_torch.serve import Engine, GenerationRequest
    from llm_tpu_torch.speculative import (
        PagedSpeculativeEngine,
        SpeculativeEngine,
    )

    tp4 = make_mesh(MeshConfig(data=1, model=4), device="cpu")
    dp_tp = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    m = load(files["llama"], "llama")
    d = load(files["draft"], "llama")

    def greedy(prompts, n=8):
        return [GenerationRequest(prompt=p, max_tokens=n,
                                  sampler=DeterministicSampler())
                for p in prompts]

    def texts(t):
        return [t[i] for i in sorted(t)]

    out = {}
    f32 = torch.float32
    out["dense"] = texts(Engine(m, max_streams=2, kv_dtype=f32,
                                mesh=tp4).generate_all(greedy(PROMPTS)))
    eng = Engine(m, max_streams=2, kv_dtype=f32, mesh=dp_tp)
    out["dense_dp_tp"] = texts(eng.generate_all(greedy(PROMPTS)))
    out["dense_dp_tp_cache_k"] = tuple(eng.cache.k.shape)
    before = tfwd.EAGER_UNDER_MESH
    reqs = [GenerationRequest(prompt=p, max_tokens=8,
                              device_sampler=DeviceSampler.greedy())
            for p in PROMPTS]
    out["dense_multi"] = texts(Engine(m, max_streams=2, kv_dtype=f32,
                                      mesh=tp4).generate_all(reqs,
                                                             n_steps=4))
    out["eager_cpu"] = tfwd.EAGER_UNDER_MESH - before
    reqs = [GenerationRequest(prompt=p, max_tokens=8,
                              device_sampler=DeviceSampler.greedy())
            for p in PROMPTS]
    out["dense_multi_dp_tp"] = texts(Engine(m, max_streams=2, kv_dtype=f32,
                                            mesh=dp_tp).generate_all(
        reqs, n_steps=4))
    out["paged"] = texts(PagedEngine(m, max_streams=2, page_size=16,
                                     kv_dtype=f32, mesh=tp4).generate_all(
        greedy(PROMPTS)))
    eng = PagedEngine(m, max_streams=1, page_size=16, kv_dtype="int8",
                      mesh=tp4)
    out["paged_int8"] = texts(eng.generate_all(greedy([[2, 3]])))
    out["pool_k"] = tuple(eng.pool.k.shape)
    out["seeded"] = texts(Engine(m, max_streams=2, kv_dtype=f32,
                                 mesh=tp4).generate_all(
        [GenerationRequest(prompt=p, max_tokens=8, sampler=default_samplers(),
                           seed=5 + i) for i, p in enumerate(PROMPTS)]))
    sp = SpeculativeEngine(m, d, k=3, max_streams=2, kv_dtype=f32, n_batch=8,
                           mesh=dp_tp)
    out["spec"] = texts(sp.generate_all(
        [GenerationRequest(prompt=p, max_tokens=10)
         for p in ([2, 3], [9, 4, 5])]))
    out["spec_drafted"] = sp.drafted
    out["spec_d_cache_k"] = tuple(sp.d_cache.k.shape)
    psp = PagedSpeculativeEngine(m, d, k=3, max_streams=1, page_size=16,
                                 kv_dtype=f32, mesh=tp4)
    out["paged_spec"] = texts(psp.generate_all(
        [GenerationRequest(prompt=[2, 3], max_tokens=10)]))
    psp = PagedSpeculativeEngine(m, d, k=3, max_streams=2, page_size=16,
                                 kv_dtype=f32, mesh=dp_tp)
    out["paged_spec_dp_tp"] = texts(psp.generate_all(
        [GenerationRequest(prompt=p, max_tokens=10)
         for p in ([2, 3], [9, 4, 5])]))
    out["paged_spec_dp_tp_d_cache_k"] = tuple(psp.d_cache.k.shape)
    return out


def audit_world(rank, world, files):
    """One TP step (1x4) and one DP x TP step (2x2), audited."""
    tp4 = make_mesh(MeshConfig(data=1, model=4), device="cpu")
    dp_tp = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    m = load(files["llama"], "llama")
    out = {}
    for name, mesh, B in (("tp", tp4, 2), ("dp_tp", dp_tp, 4)):
        p = shard_params(m.params, mesh, m.spec)
        c = shard_cache(tfwd.init_cache_batched(m.spec, B, torch.float32),
                        mesh, batched=True)
        ids = torch.tensor(BATCH_IDS[:B])
        res = audit.audit_step(
            lambda: batched_forward_step(m.spec, p, ids,
                                         torch.zeros(B, dtype=torch.int32),
                                         c), mesh)
        out[name] = (res.bytes_by_axis,
                     [(o.op, o.axis, o.bytes, o.groups) for o in res.ops],
                     res.table())
    return out


def pipeline_world(rank, world, files, cases):
    """The pipeline cases on one world: (pipe, data, M, kind)."""
    from llm_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        pipeline_forward_batched,
        pipeline_step,
        shard_cache_pipeline,
        shard_params_pipeline,
    )

    m = load(files["llama4"], "llama")
    rng = np.random.default_rng(0)
    out = {}
    meshes = {}

    def mesh_of(pipe, data):
        if (pipe, data) not in meshes:
            meshes[(pipe, data)] = make_pipeline_mesh(pipe=pipe, data=data,
                                                      device="cpu")
        return meshes[(pipe, data)]

    for pipe, data, M, kind in cases:
        mesh = mesh_of(pipe, data)
        params = shard_params_pipeline(m.params, mesh)
        kv = "int8" if kind == "int8" else torch.float32
        B = 4
        T = 2 if kind in ("int8", "mask", "step") else 3
        ids = torch.as_tensor(rng.integers(2, 90, size=(B, T)))
        cache = shard_cache_pipeline(
            tfwd.init_cache_batched(m.spec, B, kv), mesh)
        n_past = torch.zeros(B, dtype=torch.int32)
        key = (pipe, data, M, kind)
        if kind == "mask":
            wm = torch.tensor([True, False, True, False])
            lg, _, cache = pipeline_forward_batched(
                m.spec, params, ids, n_past, cache, mesh, M, write_mask=wm)
        elif kind == "step":
            lg, _, cache = pipeline_step(m.spec, params, ids, n_past, cache,
                                         mesh, M)
            lg, _, cache = pipeline_step(m.spec, params, ids, n_past + T,
                                         cache, mesh, M)
        else:
            lg, hd, cache = pipeline_forward_batched(
                m.spec, params, ids, n_past, cache, mesh, M)
            if kind == "decode":
                ids2 = torch.as_tensor(rng.integers(2, 90, size=(B, 1)))
                lg, hd, cache = pipeline_forward_batched(
                    m.spec, params, ids2, n_past + T, cache, mesh, M)
                ids = torch.cat([ids, ids2], dim=1)
        out[key] = {
            "ids": ids.numpy(), "logits": lg.numpy(),
            "k": cache.k.numpy(), "v": cache.v.numpy(),
            "k_scale": (cache.k_scale.numpy() if cache.k_scale is not None
                        else None),
            "coords": mesh.coords,
        }
    # an uneven split (2 layers over 4 stages) is refused
    mesh = mesh_of(4, 1)
    small = load(files["llama"], "llama")
    try:
        shard_params_pipeline(small.params, mesh)
        out["uneven"] = "accepted"
    except AssertionError as e:
        out["uneven"] = str(e)
    return out


def ring_world(rank, world, files, cases):
    """ring_prefill over a seq ring of the world's ranks, for each case
    (arch, ids, kv dtype): last logits and the cache."""
    from llm_tpu_torch.parallel.ring import make_seq_mesh, ring_prefill

    mesh = make_seq_mesh(device="cpu")
    out = {}
    for arch, ids, kv in cases:
        m = load(files[arch], arch)
        last, cache = ring_prefill(m.spec, m.params, torch.as_tensor(ids),
                                   mesh, kv_dtype=(torch.float32 if kv is None
                                                   else kv))
        out[(arch, kv)] = {
            "last": last.numpy(),
            **{n: (getattr(cache, n).numpy()
                   if getattr(cache, n) is not None else None)
               for n in ("k", "v", "k_scale", "v_scale")}}
    return out
