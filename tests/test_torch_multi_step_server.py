"""The port's multi-step HTTP serving (`LlmServer(multi_step=4)`, `serve
--multi-step`) against the JAX package's, on a tiny LLaMA Q4_0 checkpoint:
`device_sampler_from_params` builds the reference's samplers; a dense and a
paged server answer greedy completions (several at once, streamed or not,
with logprobs) with the reference multi-step server's text, decoding in
device blocks; requests the device cannot sample take the host steps; the
CLI's `serve --multi-step 4 --device cpu` serves. Texts are compared
exactly, logprobs within atol = rtol = 1e-5 (test_torch_step_multi.py)."""

import json
import queue
import subprocess
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import server as jserver
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops.sampling import DeviceSampler as JDeviceSampler
from llm_tpu.paged import PagedEngine as JPagedEngine
from llm_tpu.serve import Engine as JEngine
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import server as tserver
from llm_tpu_torch.paged import PagedEngine as TPagedEngine
from llm_tpu_torch.serve import Engine as TEngine

REPO = Path(__file__).resolve().parent.parent
CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
NO_EOT = {"0": -100}  # the tiny vocab's EoT is token 0
GREEDY = {"max_tokens": 9, "temperature": 0, "logit_bias": NO_EOT,
          "repeat_penalty": 1.3}
PROMPTS = ["<t5><t7><t2>", [9, 4, 5] * 5, [3] * 20]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_multi_step_server") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    return path


def _servers(model_path, paged):
    jm = j_load(model_path, "llama",
                params=JModelParameters(context_size=CTX))
    tm = tloader.load(model_path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    if paged:
        je = JPagedEngine(jm, max_streams=3, page_size=16, kv_dtype="int8",
                          n_batch=8, prefix_cache=True)
        te = TPagedEngine(tm, max_streams=3, page_size=16, kv_dtype="int8",
                          n_batch=8, prefix_cache=True)
    else:
        je = JEngine(jm, max_streams=3, kv_dtype=jnp.float32, n_batch=8)
        te = TEngine(tm, max_streams=3, kv_dtype=torch.float32, n_batch=8)
    js = jserver.LlmServer(jm, je, port=0, multi_step=4)
    ts = tserver.LlmServer(tm, te, port=0, multi_step=4)
    js.start()
    ts.start()
    return js, ts


def _stop(js, ts):
    js.httpd.shutdown()
    js.loop.shutdown()
    js.loop.join(timeout=60)
    ts.shutdown()
    assert not ts.loop.is_alive()


def _post(srv, body):
    host, port = srv.address
    req = urllib.request.Request(
        f"http://{host}:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if not body.get("stream"):
            return json.loads(resp.read())["choices"][0]
        parts = []
        for line in resp.read().decode().split("\n\n"):
            if line.startswith("data: {"):
                choice = json.loads(line[6:])["choices"][0]
                parts.append(choice["text"])
        return {"text": "".join(parts)}


def _concurrent(srv, bodies):
    with ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(lambda b: _post(srv, b), bodies))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_multi_step_server_same_text(model_path, paged):
    """Three greedy completions at once (one streamed, one with
    logprobs), then one alone: the reference multi-step server's text;
    the port's engine decoded in blocks and never fell back."""
    js, ts = _servers(model_path, paged)
    try:
        bodies = [dict(GREEDY, prompt=p, stream=i == 1,
                       **({"logprobs": 2} if i == 2 else {}))
                  for i, p in enumerate(PROMPTS)]
        bodies.append(dict(GREEDY, prompt=[11, 12]))
        # each side gets the requests in the same order, one by one, so
        # the engines admit and batch them alike
        for b in bodies:
            ref, got = _post(js, b), _post(ts, b)
            assert got["text"] == ref["text"] and got["text"].count("<t") == 9
        got = _concurrent(ts, bodies[:3])
        ref = _concurrent(js, bodies[:3])
        assert [g["text"] for g in got] == [r["text"] for r in ref]
        lp, rlp = got[2]["logprobs"], ref[2]["logprobs"]
        assert lp["tokens"] == rlp["tokens"]
        np.testing.assert_allclose(lp["token_logprobs"],
                                   rlp["token_logprobs"], **TOL)
        engine = ts.loop.engine
        assert engine.multi_blocks > 0
        assert not any(engine.multi_fallbacks.values())
    finally:
        _stop(js, ts)


def test_host_chain_requests_take_host_steps(model_path):
    """A request without a temperature (the full default chain) has no
    device sampler: the multi-step server serves it with host steps."""
    js, ts = _servers(model_path, paged=False)
    try:
        body = {"prompt": [2, 3], "max_tokens": 5, "seed": 3}
        assert _post(ts, body)["text"] == _post(js, body)["text"]
        assert ts.loop.engine.multi_blocks == 0
    finally:
        _stop(js, ts)


PARAMS = [
    {"temperature": 0}, {"temperature": 0.0, "repeat_penalty": 1.3,
                         "logit_bias": {"3": -100, "4": 2.5}},
    {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "min_p": 0.1},
    {"temperature": 0.9, "tfs_z": 0.8, "typical_p": 0.7,
     "frequency_penalty": 0.2, "presence_penalty": 0.1},
    {"temperature": 0.8, "mirostat": 2, "mirostat_tau": 4.0},
    {"temperature": 1.0, "mirostat": 1, "top_k": 3},
    {}, {"sampler": ["topk:k=2"], "temperature": 0.5},
    {"temperature": 0, "logprobs": 2},
]


@pytest.mark.parametrize("allow_logprobs", [False, True])
def test_device_sampler_from_params_matches_reference(allow_logprobs):
    for params in PARAMS:
        got = tserver.device_sampler_from_params(
            params, allow_logprobs=allow_logprobs)
        ref = jserver.device_sampler_from_params(
            params, allow_logprobs=allow_logprobs)
        assert (got is None) == (ref is None), params
        if ref is not None:
            for f in fields(JDeviceSampler):
                assert getattr(got, f.name) == getattr(ref, f.name), \
                    (params, f.name)


def test_cli_serve_multi_step_on_cpu(model_path):
    """`python -m llm_tpu_torch serve --paged --multi-step 4 ... --device
    cpu` starts, says it serves in blocks, answers a completion, and
    stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch", "serve", "-m",
         str(model_path), "-a", "llama", "--num-ctx-tokens", str(CTX),
         "--paged", "--page-size", "16", "--kv-int8", "--max-streams", "2",
         "--multi-step", "4", "--port", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = ""
        while "serving" not in line:
            line = lines.get(timeout=120)  # raises queue.Empty on a hang
        assert "blocks of 4" in line
        url = line.split(" on ")[1].split()[0]
        req = urllib.request.Request(
            url + "/v1/completions",
            data=json.dumps(dict(GREEDY, prompt="<t5><t7>")).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            text = json.loads(r.read())["choices"][0]["text"]
        assert text.count("<t") == 9
    finally:
        proc.terminate()
        proc.wait(timeout=60)
