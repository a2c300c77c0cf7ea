"""The port's HTTP server (llm_tpu_torch.server.LlmServer) against the JAX
package's (llm_tpu.server.LlmServer), both on port 0 over a tiny LLaMA Q4_0
checkpoint: the same greedy request gives the same text through the whole
HTTP round trip, streamed (SSE) or not, on a dense and on a paged engine;
/health, /v1/models and /metrics answer; stop sequences, `n` choices,
logprobs and malformed bodies behave as the reference's. Text is compared
exactly (greedy tokens are equal; see test_torch_serve.py)."""

import json
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import server as jserver
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.serve import Engine as JEngine
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import server as tserver
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.paged import PagedEngine as TPagedEngine
from llm_tpu_torch.serve import Engine as TEngine

REPO = Path(__file__).resolve().parent.parent
CTX = 64
NO_EOT = {"0": -100}  # the tiny vocab's EoT is token 0


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_server") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    return path


@pytest.fixture(scope="module")
def servers(model_path):
    """(jax server, port server), each over a dense f32 engine of 2 slots."""
    jm = j_load(model_path, "llama", params=JModelParameters(context_size=CTX))
    tm = tloader.load(model_path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    js = jserver.LlmServer(jm, JEngine(jm, max_streams=2,
                                       kv_dtype=jnp.float32, n_batch=8),
                           host="127.0.0.1", port=0)
    ts = tserver.LlmServer(tm, TEngine(tm, max_streams=2,
                                       kv_dtype=torch.float32, n_batch=8),
                           host="127.0.0.1", port=0)
    js.start()
    ts.start()
    yield js, ts
    js.httpd.shutdown()
    js.loop.shutdown()
    js.loop.join(timeout=60)
    ts.shutdown()
    assert not ts.loop.is_alive()


def _url(srv, path):
    host, port = srv.address
    return f"http://{host}:{port}{path}"


def _post(srv, body, path="/v1/completions"):
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _sse(srv, body):
    """(text fragments, finish reasons) of a streamed completion."""
    req = urllib.request.Request(
        _url(srv, "/v1/completions"),
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    frags, reasons = [], []
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        lines = resp.read().decode().split("\n\n")
    assert lines[-2] == "data: [DONE]"
    for line in lines[:-2]:
        choice = json.loads(line.removeprefix("data: "))["choices"][0]
        if choice["finish_reason"] is None:
            frags.append(choice["text"])
        else:
            reasons.append(choice["finish_reason"])
    return frags, reasons


GREEDY = {"prompt": "<t5><t7><t2>", "max_tokens": 8, "temperature": 0,
          "logit_bias": NO_EOT}


def test_completion_same_text(servers):
    js, ts = servers
    _, ref = _post(js, GREEDY)
    status, got = _post(ts, GREEDY)
    assert status == 200
    assert got["object"] == "text_completion"
    assert got["choices"][0]["text"] == ref["choices"][0]["text"]
    assert got["choices"][0]["text"].count("<t") == 8
    assert got["choices"][0]["finish_reason"] == "length"


def test_sse_stream_same_text(servers):
    js, ts = servers
    _, ref = _post(js, GREEDY)
    frags, reasons = _sse(ts, GREEDY)
    assert "".join(frags) == ref["choices"][0]["text"]
    assert len(frags) == 8 and reasons == ["length"]
    assert _sse(js, GREEDY) == (frags, reasons)


def test_health_models_metrics(servers):
    _, ts = servers
    with urllib.request.urlopen(_url(ts, "/health"), timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["pending"] == 0
    with urllib.request.urlopen(_url(ts, "/v1/models"), timeout=30) as r:
        assert json.loads(r.read())["data"][0]["object"] == "model"
    _post(ts, GREEDY)
    with urllib.request.urlopen(_url(ts, "/metrics"), timeout=30) as r:
        metrics = json.loads(r.read())
    assert metrics["requests_completed"] >= 1
    assert metrics["tokens_generated"] >= 8
    assert metrics["ttft_ms_p50"] is not None


def test_stop_n_and_logprobs_match_reference(servers):
    js, ts = servers
    _, whole = _post(ts, GREEDY)
    text = whole["choices"][0]["text"]
    stop = text[text.index("<", 10):text.index(">", 10) + 1]  # 3rd token
    body = dict(GREEDY, stop=[stop], n=2, logprobs=2)
    _, ref = _post(js, body)
    _, got = _post(ts, body)
    assert [c["text"] for c in got["choices"]] == \
        [c["text"] for c in ref["choices"]]
    assert got["choices"][0]["text"] == text[: text.index(stop)]
    assert [c["finish_reason"] for c in got["choices"]] == ["stop", "stop"]
    # the stop cancels the stream asynchronously, so either engine may have
    # decoded a token or two more: compare what both recorded
    glp, rlp = got["choices"][0]["logprobs"], ref["choices"][0]["logprobs"]
    n = min(len(glp["tokens"]), len(rlp["tokens"]))
    assert n >= 3
    assert glp["tokens"][:n] == rlp["tokens"][:n]
    np.testing.assert_allclose(glp["token_logprobs"][:n],
                               rlp["token_logprobs"][:n], rtol=1e-5,
                               atol=1e-5)


def test_bad_requests(servers):
    _, ts = servers
    for body, code in ((b"{not json", 400), (b"[1]", 400)):
        req = urllib.request.Request(_url(ts, "/v1/completions"), data=body)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == code
    for body in ({"prompt": "<t2>", "sampler": "nosuchsampler"},
                 {"prompt": "<t2>", "n": 0}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(ts, body)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(ts, GREEDY, path="/v1/chat/completions")  # not ported yet
    assert e.value.code == 404


def test_paged_server_same_text(servers, model_path):
    """A paged int8 engine with the prefix cache, served by the port,
    answers as the reference's dense server does."""
    js, _ = servers
    tm = tloader.load(model_path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    srv = tserver.LlmServer(
        tm, TPagedEngine(tm, max_streams=2, page_size=16, kv_dtype="int8",
                         n_batch=8, prefix_cache=True), port=0)
    srv.start()
    try:
        body = dict(GREEDY, prompt=[2, 3] * 10)
        _, ref = _post(js, body)
        for _ in range(2):  # the second one borrows the cached first page
            _, got = _post(srv, body)
            assert got["choices"][0]["text"] == ref["choices"][0]["text"]
        assert srv.loop.engine.prefix_cache.by_key
    finally:
        srv.shutdown()


def test_stop_scanner():
    s = tserver._StopScanner(["###", "END"])
    assert s.push("abc#") == "abc"  # "#" could start "###"
    assert s.push("#") == ""
    assert s.push("x") == "##x"
    assert s.push("EN") == ""
    assert s.push("Dtail") == "" and s.hit
    s2 = tserver._StopScanner(["b", "abc"])
    assert s2.push("xabc") == "x" and s2.hit  # the earliest match wins


def test_sampler_from_params_matches_reference():
    for params in ({"temperature": 0}, {"temperature": 0.7, "top_k": 5},
                   {"top_p": 0.9}, {"logit_bias": {"3": -100, "4": 2.5}},
                   {"sampler": ["topk:k=2"]}, {}):
        got = tserver.sampler_from_params(params, n_vocab=96)
        ref = jserver.sampler_from_params(params, n_vocab=96)
        assert type(got).__name__ == type(ref).__name__
        gt = [type(t).__name__ for t in got.transforms]
        assert gt == [type(t).__name__ for t in ref.transforms]
        assert type(got.terminal).__name__ == type(ref.terminal).__name__


def test_cli_serve_without_device_raises(model_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_main(["serve", "-m", str(model_path), "-a", "llama",
                "--no-warmup", "--port", "0"])


@pytest.mark.parametrize("flags", [["--kv-int4"], ["--prefix-cache"],
                                   ["--paged", "--kv-int4", "--kv-int8"]])
def test_cli_serve_argument_checks(model_path, flags):
    with pytest.raises(SystemExit):
        t_main(["serve", "-m", str(model_path), "-a", "llama",
                "--device", "cpu", *flags])


def test_cli_serve_paged_on_cpu(model_path):
    """`python -m llm_tpu_torch serve --paged ... --device cpu` starts, warms
    up, answers a completion, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch", "serve", "-m",
         str(model_path), "-a", "llama", "--num-ctx-tokens", str(CTX),
         "--paged", "--page-size", "16", "--kv-int4", "--prefix-cache",
         "--max-streams", "2", "--port", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = ""
        while "serving" not in line:
            line = lines.get(timeout=120)  # raises queue.Empty on a hang
        url = line.split(" on ")[1].split()[0]
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps(GREEDY).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            text = json.loads(r.read())["choices"][0]["text"]
        assert text.count("<t") == 8
    finally:
        proc.terminate()
        proc.wait(timeout=60)
