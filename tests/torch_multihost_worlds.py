"""Rank functions of the port's multi-host tests
(tests/test_torch_multihost.py, tests/test_torch_multihost_serving.py).
Each test module spawns one gloo world on the CPU
(`llm_tpu_torch.parallel.launch.spawn`, a `file://` store under the
test's tmp_path) that runs one of these functions; every case's results
come back to the parent as plain values. This module imports only torch
and the port, so a rank starts quickly."""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

import torch
import torch.distributed as dist

from llm_tpu_torch import loader as tloader
from llm_tpu_torch.engine_snapshot import read_engine, write_engine
from llm_tpu_torch.ops.sampling import DeviceSampler, mirostat_mu_init
from llm_tpu_torch.parallel import collectives_audit as audit
from llm_tpu_torch.parallel import multihost as mh
from llm_tpu_torch.parallel.sharding import MeshConfig, make_mesh
from llm_tpu_torch.samplers import DeterministicSampler, GreedySampler
from llm_tpu_torch.serve import GenerationRequest
from llm_tpu_torch.session import SnapshotError

CTX = 64
F32 = torch.float32
BF16 = torch.bfloat16
# each host's own prompts (host 1's second is long: its chunked prefill
# interleaves with the other hosts' decode)
HOST_PROMPTS = {0: [[2, 3], [9, 4, 5]], 1: [[7, 8], [5, 6] * 8],
                2: [[11, 12], [4, 4, 4]], 3: [[6], [10, 3, 2, 7]]}
MESHES = {"dp_tp": (2, 2), "dp": (4, 1)}


def load(path, ctx=CTX):
    return tloader.load(path, "llama",
                        params=tloader.ModelParameters(context_size=ctx),
                        device="cpu")


def _det(prompts, n=8):
    return [GenerationRequest(prompt=p, max_tokens=n,
                              sampler=DeterministicSampler())
            for p in prompts]


def _greedy_dev(prompts, n=8, **kw):
    return [GenerationRequest(prompt=p, max_tokens=n,
                              device_sampler=DeviceSampler.greedy(), **kw)
            for p in prompts]


def _texts(engine, ids):
    return ["".join(engine.finished[r].text) for r in ids]


def _run(engine, reqs, n_steps=1):
    ids = [engine.submit(r) for r in reqs]
    while engine.has_work_global():
        if n_steps > 1:
            engine.step_multi(n_steps)
        else:
            engine.step()
    return ids


def _audit(res) -> dict:
    return {"by_axis": res.bytes_by_axis,
            "ops": [(o.op, o.axis, o.bytes) for o in res.ops]}


def engine_cases(m, mesh) -> dict:
    """The cases of tests/test_multihost.py on one mesh; host d runs
    HOST_PROMPTS[d] where the reference test submits several prompts."""
    host = mesh.coords["data"]
    data = mesh.shape["data"]
    P = HOST_PROMPTS[host]
    out = {}
    Eng, Paged = mh.MultiHostEngine, mh.MultiHostPagedEngine

    e = Eng(m, mesh, global_streams=2 * data, kv_dtype=F32, n_batch=4)
    ids = _run(e, _det(P))
    out["dense"] = _texts(e, ids)
    out["ids"] = ids
    out["slots"] = (e.max_streams, e._row0, tuple(e.cache.k.shape))

    e = Eng(m, mesh, global_streams=data, kv_dtype="int8", n_batch=4)
    out["dense_int8"] = _texts(e, _run(e, _det([[2, 3]])))

    e = Eng(m, mesh, global_streams=2 * data, kv_dtype=F32, n_batch=4)
    out["multi"] = _texts(e, _run(e, _greedy_dev(P), n_steps=4))
    out["multi_blocks"] = e.multi_blocks

    # admission near the context boundary: B's n_batch-wide prefill gives
    # A (decoding near n_ctx) a dummy row that must not write
    e = Eng(m, mesh, global_streams=2 * data, kv_dtype=F32, n_batch=8)
    a = e.submit(GenerationRequest(prompt=[2] * 41, max_tokens=20,
                                   sampler=GreedySampler()))
    for _ in range(21):
        e.step()
    out["boundary_n_past"] = e.slots[0].n_past
    e.submit(GenerationRequest(prompt=[5, 6, 7], max_tokens=2,
                               sampler=GreedySampler()))
    while e.has_work_global():
        e.step()
    out["boundary"] = "".join(e.finished[a].text)

    e = Paged(m, mesh, global_streams=2 * data, kv_dtype=BF16, n_batch=4,
              page_size=8)
    out["paged"] = _texts(e, _run(e, _det(P)))
    out["pool_k"] = tuple(e.pool.k.shape)
    for kv in ("int8", "int4"):
        e = Paged(m, mesh, global_streams=data, kv_dtype=kv, n_batch=4,
                  page_size=8)
        out[f"paged_{kv}"] = _texts(e, _run(e, _det([[2, 3, 4]])))

    e = Paged(m, mesh, global_streams=data, kv_dtype=BF16, n_batch=4,
              page_size=8, n_pages=2)
    rid = e.submit(GenerationRequest(prompt=[2] * 20, max_tokens=4,
                                     sampler=DeterministicSampler()))
    for _ in range(30):
        if not e.has_work_global():
            break
        e.step()
    out["kv_oom"] = e.finished[rid].finish_reason

    e = Paged(m, mesh, global_streams=2 * data, kv_dtype=BF16, n_batch=4,
              page_size=8)
    out["paged_multi"] = _texts(e, _run(e, _greedy_dev(P, 9), n_steps=4))

    e = Paged(m, mesh, global_streams=data, kv_dtype=BF16, n_batch=4,
              page_size=8, n_pages=3)
    out["pool_pressure"] = _texts(e, _run(e, _greedy_dev([[2, 3]]),
                                          n_steps=16))
    out["pool_pressure_fallbacks"] = e.multi_fallbacks["tight_pool"]

    e = Eng(m, mesh, global_streams=2 * data, kv_dtype=F32, n_batch=4)
    ids = _run(e, [
        GenerationRequest(prompt=[2, 3], max_tokens=6, logprobs=2,
                          device_sampler=DeviceSampler.greedy()),
        GenerationRequest(prompt=[9, 4], max_tokens=6,
                          device_sampler=DeviceSampler.greedy())],
        n_steps=4)
    out["multi_logprobs"] = e.finished[ids[0]].logprob_data

    e = Paged(m, mesh, global_streams=data, kv_dtype=F32, page_size=16,
              n_batch=16)
    ids = _run(e, [GenerationRequest(
        prompt=[2, 3], max_tokens=5, logprobs=2,
        device_sampler=DeviceSampler.greedy())], n_steps=4)
    out["paged_multi_logprobs"] = e.finished[ids[0]].logprob_data

    ds = DeviceSampler(kind="greedy", repeat_penalty=1.4, penalty_last_n=8)
    e = Eng(m, mesh, global_streams=2 * data, kv_dtype=F32, n_batch=4)
    ids = _run(e, [GenerationRequest(prompt=[2, 3], max_tokens=10,
                                     device_sampler=ds),
                   GenerationRequest(prompt=[9, 4], max_tokens=10,
                                     device_sampler=DeviceSampler.greedy())],
               n_steps=4)
    out["multi_penalties"] = _texts(e, ids[:1])
    e = Paged(m, mesh, global_streams=data, kv_dtype=F32, page_size=16,
              n_batch=16)
    out["paged_multi_penalties"] = _texts(e, _run(e, [GenerationRequest(
        prompt=[2, 3], max_tokens=10, device_sampler=ds)], n_steps=4))

    ms = DeviceSampler(kind="sample", temperature=0.9, mirostat=2,
                       mirostat_tau=4.0)
    e = Eng(m, mesh, global_streams=2 * data, kv_dtype=F32, n_batch=4)
    g = e.submit(GenerationRequest(prompt=[2, 3], max_tokens=8,
                                   device_sampler=DeviceSampler.greedy()))
    mi = e.submit(GenerationRequest(prompt=[9, 4, 5], max_tokens=8,
                                    device_sampler=ms))
    mus = []
    while e.has_work_global():
        e.step_multi(4)
        mus += [s.mirostat_mu for s in e.slots
                if s is not None and s.request.device_sampler.mirostat]
    out["multi_mirostat"] = ("".join(e.finished[g].text),
                             "".join(e.finished[mi].text),
                             any(x != mirostat_mu_init(ms) for x in mus)
                             and bool(mus))
    e = Paged(m, mesh, global_streams=2 * data, kv_dtype="int8", n_batch=4,
              page_size=8)
    g = e.submit(GenerationRequest(prompt=[2, 3], max_tokens=6,
                                   device_sampler=DeviceSampler.greedy()))
    mi = e.submit(GenerationRequest(
        prompt=[9, 4, 5], max_tokens=6,
        device_sampler=DeviceSampler(kind="sample", temperature=0.9,
                                     mirostat=1)))
    while e.has_work_global():
        e.step_multi(4)
    out["paged_multi_mirostat"] = ("".join(e.finished[g].text),
                                   "".join(e.finished[mi].text))

    # the zero-`data`-bytes audits: one decode step, one block, one paged
    # decode step, each once the streams decode
    for name, make, multi in (
            ("audit_decode", lambda: Eng(m, mesh, global_streams=2 * data,
                                         kv_dtype=F32, n_batch=4), False),
            ("audit_block", lambda: Eng(m, mesh, global_streams=2 * data,
                                        kv_dtype=F32, n_batch=4), True),
            ("audit_paged", lambda: Paged(m, mesh, global_streams=2 * data,
                                          kv_dtype=BF16, n_batch=4,
                                          page_size=8), False)):
        e = make()
        reqs = (_greedy_dev([[2, 3], [9, 4]], 12) if multi
                else _det([[2, 3], [9, 4]], 12))
        for r in reqs:
            e.submit(r)
        for _ in range(2):  # the prompts' chunks, then a decode
            e.step()
        res = audit.audit_step(
            (lambda: e.step_multi(4)) if multi else e.step, mesh)
        out[name] = _audit(res)
        while e.has_work_global():
            e.step()
    return out


def rows_http(m, mesh, timeout: float = 120.0) -> dict:
    """An LlmServer on each rank of a (2, 2) mesh: the rows' leaders bind
    addresses and serve their prompts at temperature 0; the followers
    bind none and run their leader's requests. Then the leaders stop."""
    from llm_tpu_torch.server import LlmServer

    data = mesh.shape["data"]
    e = mh.MultiHostEngine(m, mesh, global_streams=2 * data, kv_dtype=F32,
                           n_batch=4)
    srv = LlmServer(m, e, host="127.0.0.1", port=0)
    out = {"loop": type(srv.loop).__name__, "address": srv.address,
           "leader": e.control.leader}
    srv.start()
    if srv.address is not None:
        out["texts"] = [
            http_completion(srv.address, {"prompt": p, "max_tokens": 8,
                                          "temperature": 0}, timeout)
            for p in HOST_PROMPTS[mesh.coords["data"]]]
        srv.loop.shutdown()
    srv.loop.join(timeout=timeout)
    out["loop_alive"] = srv.loop.is_alive()
    out["finished"] = {r: "".join(s.text) for r, s in e.finished.items()}
    if srv.httpd is not None:
        srv.httpd.shutdown()
        srv.httpd.server_close()
    return out


def engines_world(rank, world, files) -> dict:
    """Every case on the (2, 2) mesh, then on the (4, 1) mesh; the (2, 2)
    rows also serve HTTP."""
    mh.CONTROL_TIMEOUT_S = 120.0
    m = load(files["llama"])
    out = {}
    for name, (d, mp) in MESHES.items():
        mesh = make_mesh(MeshConfig(data=d, model=mp), device="cpu")
        res = engine_cases(m, mesh)
        res["coords"] = dict(mesh.coords)
        out[name] = res
    mesh = make_mesh(MeshConfig(2, 2), device="cpu")
    out["rows_http"] = rows_http(m, mesh)
    return out


# -- the serving world (2 ranks, (data, model) = (2, 1)) ---------------------


def http_completion(address, body: dict, timeout: float = 120.0) -> str:
    host, port = address
    req = urllib.request.Request(
        f"http://{host}:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())["choices"][0]["text"]


def http_post(address, route: str, body: dict) -> tuple:
    host, port = address
    req = urllib.request.Request(
        f"http://{host}:{port}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _finished(engine) -> dict:
    return {rid: (list(s.tokens), "".join(s.text), s.finish_reason)
            for rid, s in engine.finished.items()}


SNAP_LONG = "".join(f"<t{i}>" for i in range(2, 22))


def snap_requests(host: int) -> list:
    """tests/test_torch_engine_snapshot.py's mid-flight mix, per host: a
    deterministic stream with logprobs, a seeded stateful chain, a long
    prompt mid-prefill at the checkpoint, and (host 0) one more."""
    from llm_tpu_torch import samplers as S

    reqs = [
        GenerationRequest(prompt="<t2><t3>" if host == 0 else "<t5><t6>",
                          max_tokens=8, sampler=S.DeterministicSampler(),
                          logprobs=2),
        GenerationRequest(prompt="<t9><t4>", max_tokens=8, seed=7 + host,
                          sampler=S.SamplerChain(
                              [S.TopK(k=5), S.Temperature(temperature=0.7)],
                              S.Mirostat2(tau=3.0, eta=0.3))),
        GenerationRequest(prompt=SNAP_LONG, max_tokens=5,
                          sampler=S.DeterministicSampler()),
    ]
    if host == 0:
        reqs.append(GenerationRequest(prompt="<t7><t8>", max_tokens=6,
                                      sampler=S.DeterministicSampler()))
    return reqs


def checkpoint_equivalence(make, host: int, path: str, steps: int = 3):
    """The engine checkpointed mid-flight (each rank its own file), a
    fresh engine restored from it: both finish alike."""
    a = make()
    for r in snap_requests(host):
        a.submit(r)
    for _ in range(steps):
        a.step()
    write_engine(a, path)
    b = make()
    read_engine(b, path)
    same_id = b._next_id == a._next_id and b._steps == a._steps
    while a.has_work_global():
        a.step()
    while b.has_work_global():
        b.step()
    la = [s.logprob_data for s in a.finished.values() if s.logprob_data]
    lb = [s.logprob_data for s in b.finished.values() if s.logprob_data]
    return {"equal": _finished(a) == _finished(b), "same_next_id": same_id,
            "logprobs_equal": la == lb and bool(la),
            "finished": {str(k): v for k, v in _finished(b).items()}}


def serving_world(rank, world, files, d) -> dict:
    """The phases of tests/mh/worker.py (engine, greedy step_multi, paged,
    checkpoint, HTTP) on (data, model) = (2, 1), the per-rank engine
    checkpoints of tests/test_engine_snapshot.py, the server's consensus
    stop and shutdown checkpoint, and last a world put out of step."""
    from llm_tpu_torch.server import LlmServer

    mh.CONTROL_TIMEOUT_S = 120.0
    m = load(files["llama"])
    mesh = make_mesh(MeshConfig(data=world, model=1), device="cpu")
    host = mesh.coords["data"]
    P = HOST_PROMPTS[host]
    Eng, Paged = mh.MultiHostEngine, mh.MultiHostPagedEngine
    out = {"host": host}

    e = Eng(m, mesh, global_streams=2 * world, kv_dtype=F32, n_batch=4)
    out["texts"] = _texts(e, _run(e, _det(P)))
    e = Eng(m, mesh, global_streams=2 * world, kv_dtype=F32, n_batch=4)
    out["multi"] = _texts(e, _run(e, _greedy_dev(P), n_steps=4))
    e = Paged(m, mesh, global_streams=2 * world, kv_dtype=BF16, n_batch=4,
              page_size=8)
    out["paged"] = _texts(e, _run(e, _det(P)))

    # the worker's checkpoint phase: a paged engine checkpointed after 3
    # lockstep steps, one file a rank, restored into a fresh engine
    def paged():
        return Paged(m, mesh, global_streams=2 * world, kv_dtype=BF16,
                     n_batch=4, page_size=8)

    e5 = paged()
    for r in _det(P):
        e5.submit(r)
    for _ in range(3):
        e5.step()
    ck = os.path.join(d, f"worker.ckpt.host{rank}")
    write_engine(e5, ck)
    e6 = paged()
    read_engine(e6, ck)
    while e6.has_work_global():
        e6.step()
    out["ckpt"] = ["".join(e6.finished[r].text) for r in sorted(e6.finished)]

    # tests/test_engine_snapshot.py's per-host roundtrips
    out["snap_dense"] = checkpoint_equivalence(
        lambda: Eng(m, mesh, global_streams=4 * world, kv_dtype=F32,
                    n_batch=4), host, os.path.join(d, f"dense.host{rank}"))
    out["snap_paged"] = checkpoint_equivalence(
        lambda: Paged(m, mesh, global_streams=4 * world, kv_dtype="int8",
                      n_batch=4, page_size=8),
        host, os.path.join(d, f"paged.host{rank}"))
    # another rank's file is another layout: refused, naming both
    dist.barrier()
    other = os.path.join(d, f"paged.host{(rank + 1) % world}")
    fresh = Paged(m, mesh, global_streams=4 * world, kv_dtype="int8",
                  n_batch=4, page_size=8)
    try:
        read_engine(fresh, other)
        out["swapped"] = None
    except SnapshotError as err:
        out["swapped"] = str(err)
    out["swapped_untouched"] = not fresh.has_work()

    # HTTP: each rank's LlmServer over the cross-host engine
    e4 = Eng(m, mesh, global_streams=2 * world, kv_dtype=F32, n_batch=4)
    snap = os.path.join(d, "served.snap")
    srv = LlmServer(m, e4, host="127.0.0.1", port=0, engine_snapshot=snap)
    out["loop"] = type(srv.loop).__name__
    out["snapshot_path"] = srv.engine_snapshot
    srv.start()
    out["http"] = [http_completion(srv.address, {"prompt": p,
                                                 "max_tokens": 8,
                                                 "temperature": 0})
                   for p in P]
    out["live_checkpoint"] = http_post(srv.address, "/admin/checkpoint", {})
    # the consensus stop: rank 0 asks first; the world exits only once
    # rank 1 has asked too
    dist.barrier()
    if rank == 0:
        srv.loop.shutdown()
        time.sleep(1.0)
        out["alive_after_own_stop"] = srv.loop.is_alive()
    else:
        time.sleep(2.0)
        srv.loop.shutdown()
    srv.loop.join(timeout=120)
    out["loop_alive"] = srv.loop.is_alive()
    srv.httpd.shutdown()
    srv.httpd.server_close()
    out["snapshot_written"] = os.path.exists(srv.engine_snapshot)
    restored = Eng(m, mesh, global_streams=2 * world, kv_dtype=F32,
                   n_batch=4)
    read_engine(restored, srv.engine_snapshot)
    out["restored_steps"] = restored._steps
    out["served_steps"] = e4._steps

    # the restore is agreed over the world: with both files good every
    # rank restores; with rank 1's file corrupt every rank sets its file
    # aside and starts fresh
    def served():
        e = Eng(m, mesh, global_streams=2 * world, kv_dtype=F32, n_batch=4)
        LlmServer(m, e, host="127.0.0.1", port=0,
                  engine_snapshot=snap).httpd.server_close()
        return e

    out["agreed_restore_steps"] = served()._steps
    dist.barrier()
    if rank == 1:
        with open(srv.engine_snapshot, "wb") as f:
            f.write(b"not a checkpoint")
    dist.barrier()
    out["refused_restore"] = (
        served()._steps, os.path.exists(srv.engine_snapshot + ".corrupt"),
        os.path.exists(srv.engine_snapshot))

    # the world's mesh: `model` defaults to the ranks on this node (both
    # here); a width that does not divide the world, or streams that do
    # not split over the hosts, are refused on every rank
    default = mh.multihost_mesh(device="cpu")
    out["default_mesh"] = (default.shape, default.coords)
    out["mesh_1"] = mh.multihost_mesh(1, device="cpu").shape
    refused = []
    for make in (lambda: mh.multihost_mesh(3, device="cpu"),
                 lambda: Eng(m, mesh, global_streams=3, kv_dtype=F32,
                             n_batch=4),
                 lambda: Eng(m, mesh, global_streams=4, kv_dtype=F32,
                             n_batch=5)):
        try:
            make()
            refused.append(None)
        except ValueError as err:
            refused.append(str(err))
    out["refused"] = refused

    # a world out of step fails within its control timeout, naming the
    # rank: rank 0 asks for the world's work; rank 1 never answers
    mh.CONTROL_TIMEOUT_S = 3.0  # its own control groups, failing fast
    eng = Eng(m, mesh, global_streams=2 * world, kv_dtype=F32, n_batch=4)
    if rank == 0:
        t0 = time.monotonic()
        try:
            eng.has_work_global()
            out["desync"] = None
        except mh.ControlDesync as err:
            out["desync"] = str(err)
        out["desync_s"] = time.monotonic() - t0
    else:
        time.sleep(6.0)
    return out
