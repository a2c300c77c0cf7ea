"""Multi-host serving in the port (server._MultiHostEngineLoop, the
per-rank engine checkpoints of engine_snapshot, serve's multi-host flags)
against the JAX package, mirroring tests/test_server.py:286 (the loop is
chosen and the consensus stop works), tests/test_engine_snapshot.py:219-247
(per-host dense and paged roundtrips), tests/mh/worker.py's phases (the
engine, greedy step_multi, paged, checkpoint and HTTP) and
tests/test_server.py:460 (`serve --multihost` of one process, here
`--device cpu` over gloo).

One gloo world of 2 ranks, (data, model) = (2, 1), on the CPU
(tests/torch_multihost_worlds.serving_world) over the tiny LLaMA (f32,
context 64); each host's texts equal the JAX package's engine on its
prompts. Added: `--draft-model` and `--prefix-cache` with `--multihost`
are refused as the reference refuses them; two ranks on one card under
nccl raise; a world put out of step fails within its control timeout,
naming the rank."""

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

import llm_tpu.loader as jloader
import llm_tpu.serve as jserve
import torch_multihost_worlds as worlds
from llm_tpu.samplers import DeterministicSampler as JDeterministic
from llm_tpu.samplers import GreedySampler as JGreedy
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.parallel import launch
from llm_tpu_torch.parallel import multihost as mh
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mh_serving")
    files = {"llama": str(d / "llama.bin")}
    make_tiny_file("llama", files["llama"])
    res = launch.spawn(worlds.serving_world, 2, "gloo", d / "store",
                       timeout=300, args=(files, str(d)))
    return d, res


@pytest.fixture(scope="module")
def jmodel(world):
    d, _ = world
    return jloader.load(d / "llama.bin", "llama",
                        params=jloader.ModelParameters(context_size=64))


_REFS: dict = {}


def _ref(jmodel, host, kind):
    """The JAX engine's texts of the host's prompts: deterministic f32
    ("texts"), greedy f32 ("greedy"), deterministic bf16 ("bf16")."""
    key = (host, kind)
    if key not in _REFS:
        P = worlds.HOST_PROMPTS[host]
        kv = jnp.bfloat16 if kind == "bf16" else jnp.float32
        sampler = JGreedy if kind == "greedy" else JDeterministic
        out = jserve.Engine(jmodel, max_streams=len(P), kv_dtype=kv) \
            .generate_all([jserve.GenerationRequest(
                prompt=p, max_tokens=8, sampler=sampler()) for p in P])
        _REFS[key] = [out[i] for i in sorted(out)]
    return _REFS[key]


# the worker's phases and the reference texts each must equal
PHASES = {"texts": "texts", "multi": "greedy", "paged": "bf16",
          "ckpt": "bf16", "http": "greedy"}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_worker_phases(world, jmodel, phase):
    """Each host serves its own prompts through the cross-host engine:
    host-sampled dense, greedy blocks, row-local bf16 pools, a paged
    engine checkpointed mid-flight and restored (one file a rank), and
    each rank's HTTP server at temperature 0."""
    _, res = world
    for r in res:
        assert r[phase] == _ref(jmodel, r["host"], PHASES[phase]), r["host"]


def test_server_multihost_loop_and_consensus_stop(world):
    """LlmServer picks the collective per-rank loop for a multi-host
    engine; rank 0 asks to stop first and its loop runs on until rank 1
    has asked too; then every loop exits."""
    _, res = world
    for r in res:
        assert r["loop"] == "_MultiHostEngineLoop"
        assert not r["loop_alive"]
    assert res[0]["alive_after_own_stop"]


def test_live_checkpoint_refused(world):
    _, res = world
    for r in res:
        status, body = r["live_checkpoint"]
        assert status == 409
        assert "not supported on multi-host serving" in body["error"]


def test_shutdown_checkpoint_per_rank(world):
    """With engine_snapshot PATH each rank's file is PATH.host<rank>,
    written on the coordinated shutdown and restorable (its step counter
    with it)."""
    d, res = world
    for rank, r in enumerate(res):
        assert r["snapshot_path"] == str(d / f"served.snap.host{rank}")
        assert r["snapshot_written"]
        assert r["restored_steps"] == r["served_steps"] > 0


def test_restore_agreed_over_world(world):
    """LlmServer restores a multi-host engine only when every rank can:
    with both files good every rank restores (its step counter with it);
    with rank 1's file corrupt every rank moves its own file to `.corrupt`
    and serves a fresh engine, so the world stays in step."""
    _, res = world
    for r in res:
        assert r["agreed_restore_steps"] == r["served_steps"] > 0
        steps, moved, left = r["refused_restore"]
        assert steps == 0 and moved and not left


def test_block_noise_depends_on_row_and_step():
    """A sampled block's noise for a stream depends only on its global row
    and the step: rows 2 and 3 drawn by host 1 of 2 hosts x 2 slots, by
    hosts 2 and 3 of 4 x 1 and by one host of 4 slots are the same; a
    rank draws its own rows only; another step draws other noise; a
    greedy block draws none."""
    def noise(row0, local, hosts, steps=5, sample=True):
        e = SimpleNamespace(device=torch.device("cpu"), _steps=steps,
                            global_streams=local * hosts, _row0=row0,
                            max_streams=local,
                            spec=SimpleNamespace(n_vocab=11))
        return mh.MultiHostEngine._block_noise(
            e, SimpleNamespace(sample=sample), 3)

    two = noise(2, 2, 2)
    assert two.shape == (3, 2, 11)
    assert bool(((two > 0) & (two < 1)).all())
    assert torch.equal(two[:, :1], noise(2, 1, 4))
    assert torch.equal(two[:, 1:], noise(3, 1, 4))
    assert torch.equal(two, noise(0, 4, 1)[:, 2:])
    assert not torch.equal(two, noise(2, 2, 2, steps=6))
    assert not torch.equal(two[:, 0], two[:, 1])
    assert noise(2, 2, 2, sample=False) is None


@pytest.mark.parametrize("kind", ["snap_dense", "snap_paged"])
def test_multihost_roundtrip(world, kind):
    """A rank's engine checkpointed mid-flight (a stream mid-prefill, one
    pending, a seeded mirostat chain, logprobs) into its own file and
    restored in a fresh engine finishes exactly as the uninterrupted
    one: dense f32 and paged int8."""
    _, res = world
    for r in res:
        snap = r[kind]
        assert snap["equal"] and snap["same_next_id"]
        assert snap["logprobs_equal"]


def test_layout_mismatch_refused(world):
    """Another rank's file is another layout: refused with a
    SnapshotError naming both, the fresh engine left as it was."""
    _, res = world
    for rank, r in enumerate(res):
        msg = r["swapped"]
        assert msg and msg.startswith("process layout mismatch")
        assert f"'process_index': {1 - rank}" in msg.split("engine")[0]
        assert f"'process_index': {rank}" in msg.split("engine")[1]
        assert r["swapped_untouched"]


def test_desynced_world_fails_within_timeout(world):
    """Rank 0 asks for the world's work and rank 1 never answers: the
    control all-gather fails within its 3 s timeout and names rank 0."""
    _, res = world
    msg = res[0]["desync"]
    assert msg and msg.startswith("rank 0: the control all-gather")
    assert res[0]["desync_s"] < 30


def test_multihost_mesh_and_refusals(world):
    """multihost_mesh's `model` defaults to the ranks on this node (both
    ranks of this world), 1 gives (2, 1); a width that does not divide
    the world, streams that do not split over the hosts and an n_batch
    that does not divide n_ctx are refused."""
    _, res = world
    for rank, r in enumerate(res):
        shape, coords = r["default_mesh"]
        assert shape == {"data": 1, "model": 2}
        assert coords == {"data": 0, "model": rank}
        assert r["mesh_1"] == {"data": 2, "model": 1}
        mesh, streams, batch = r["refused"]
        assert "does not divide the world's 2 ranks" in mesh
        assert "3 streams do not split over 2 hosts" in streams
        assert "n_batch 5 does not divide n_ctx 64" in batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_multihost_single_process(world, tmp_path):
    """`serve --multihost` of a world of one (its own coordinator, gloo on
    the CPU) builds the mesh, warms up, serves one request and exits on
    SIGINT."""
    d, _ = world
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch", "serve",
         "-m", str(d / "llama.bin"), "-a", "llama", "--num-ctx-tokens", "64",
         "--multihost", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--num-processes", "1", "--process-id", "0",
         "--port", "0", "--max-streams", "2", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    seen = []
    try:
        while not seen or "serving" not in seen[-1]:
            seen.append(lines.get(timeout=120))
        assert "rank 0 of 1 on gloo" in seen[-1]
        url = seen[-1].split(" on ")[1].split()[0]
        req = urllib.request.Request(
            url + "/v1/completions",
            data=json.dumps({"prompt": "<t5>", "max_tokens": 3,
                             "temperature": 0}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["choices"][0]["text"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("flags,message", [
    (["--draft-model", "DRAFT"], "--draft-model with --multihost: not yet"),
    (["--paged", "--prefix-cache"],
     "--prefix-cache requires --paged (single-host)"),
])
def test_cli_multihost_refusals(world, flags, message):
    """The reference's refusals, before the world is joined and the model
    loads."""
    d, _ = world
    model = str(d / "llama.bin")
    flags = [model if f == "DRAFT" else f for f in flags]
    with pytest.raises(SystemExit) as exc:
        t_main(["serve", "-m", model, "-a", "llama", "--multihost",
                "--device", "cpu", *flags])
    assert str(exc.value) == message


def test_build_engine_refuses_draft_under_multihost():
    from llm_tpu_torch.server import build_engine

    with pytest.raises(ValueError, match="not yet"):
        build_engine(object(), multihost=True, draft=object())
    with pytest.raises(ValueError, match=r"\(single-host\)"):
        build_engine(object(), paged=True, prefix_cache=True, multihost=True)


def test_nccl_two_ranks_on_one_card_raise():
    """nccl takes one card a rank: two ranks of one host on one card
    raise, naming the host and the count; one a card is fine."""
    with pytest.raises(RuntimeError, match="2 ranks on host 'h' share 1"):
        mh.card_for(["h", "h"], 1, 1)
    assert mh.card_for(["h", "h", "g"], 1, 2) == 1
    assert mh.card_for(["h", "g"], 1, 1) == 0
