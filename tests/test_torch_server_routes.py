"""The port server's chat, embeddings and checkpoint routes
(llm_tpu_torch.server) against the JAX package's (llm_tpu.server), both on
port 0 over a tiny LLaMA Q4_0 (context 64), mirroring
tests/test_server.py:222, 244, 355, 575, 604, 638, 704:
`render_chat` renders what the reference renders (a per-request dict, the
model's jinja template, the built-in default; every template failure a
ValueError); /v1/chat/completions answers the reference's text, streamed
and not, with `n` choices and the user prefix in the stop set, and
equals /v1/completions on the rendered prompt; /v1/embeddings gives the
reference's vectors within atol = rtol = 1e-5 (f32 on the CPU, the sums
in another order) and the same 400; /admin/checkpoint answers 200 or 409
as the reference does, a server writes its final checkpoint on shutdown,
restores one at start (the streams finish headless with the uninterrupted
run's text), and sets a corrupt one aside as `.corrupt`."""

import json
import os
import queue
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu import server as jserver
from llm_tpu.ggml.gguf import convert_ggml_to_gguf
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.serve import Engine as JEngine
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import server as tserver
from llm_tpu_torch.engine_snapshot import write_engine
from llm_tpu_torch.samplers import DeterministicSampler
from llm_tpu_torch.serve import Engine, GenerationRequest
from llm_tpu_torch.session import (
    InferenceSession,
    InferenceSessionConfig,
    OutputRequest,
)
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
NO_EOT = {"0": -100}  # the tiny vocab's EoT is token 0
TINY_TEMPLATE = {
    "system": "{content}",
    "user": "<t11>{content}",
    "assistant": "<t12>{content}",
    "generation_prefix": "<t12>",
    "stop": "<t11>",
}
MESSAGES = [{"role": "system", "content": "<t3>"},
            {"role": "user", "content": "<t5><t7>"}]
JINJA = ("{% for m in messages %}<t2>{{ m.content }}"
         "{% endfor %}{% if add_generation_prompt %}<t3>{% endif %}")


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_routes") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    return path


def _load_t(path):
    return tloader.load(path, "llama",
                        params=tloader.ModelParameters(context_size=CTX),
                        device="cpu")


def _load_j(path):
    return j_load(path, "llama", params=JModelParameters(context_size=CTX))


@pytest.fixture(scope="module")
def models(model_path):
    return _load_j(model_path), _load_t(model_path)


@pytest.fixture(scope="module")
def servers(models):
    """(jax server, port server), each over a dense f32 engine of 2 slots,
    with no engine snapshot configured."""
    jm, tm = models
    js = jserver.LlmServer(jm, JEngine(jm, max_streams=2,
                                       kv_dtype=jnp.float32, n_batch=8),
                           host="127.0.0.1", port=0)
    ts = tserver.LlmServer(tm, Engine(tm, max_streams=2,
                                      kv_dtype=torch.float32, n_batch=8),
                           host="127.0.0.1", port=0)
    js.start()
    ts.start()
    yield js, ts
    _stop_j(js)
    ts.shutdown()


def _stop_j(js):
    js.httpd.shutdown()
    js.loop.shutdown()
    js.loop.join(timeout=60)


def _url(srv, path):
    host, port = srv.address
    return f"http://{host}:{port}{path}"


def _post(srv, body, path="/v1/completions"):
    """(status, JSON body), for error statuses too."""
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _chat_stream(srv, body):
    """(content deltas, finish reasons by choice) of a streamed chat."""
    req = urllib.request.Request(
        _url(srv, "/v1/chat/completions"),
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    deltas, finish = {}, {}
    with urllib.request.urlopen(req, timeout=120) as resp:
        lines = resp.read().decode().split("\n\n")
    assert lines[-2] == "data: [DONE]"
    for line in lines[:-2]:
        chunk = json.loads(line.removeprefix("data: "))
        assert chunk["object"] == "chat.completion.chunk"
        c = chunk["choices"][0]
        deltas.setdefault(c["index"], []).append(
            c["delta"].get("content", ""))
        if c["finish_reason"]:
            finish[c["index"]] = c["finish_reason"]
    return {i: "".join(d) for i, d in deltas.items()}, finish


def test_render_chat_matches_reference():
    cases = [
        (MESSAGES, TINY_TEMPLATE, None),
        (MESSAGES, None, None),
        ([{"role": "tool", "content": "x"}], None, None),  # unknown role
        (MESSAGES, None, JINJA),
        ([{"role": "user", "content": "hi"}],
         {"user": "U:{content}\n", "generation_prefix": "A:", "stop": "U:"},
         JINJA),  # a per-request dict wins over the jinja template
    ]
    for messages, template, jinja in cases:
        assert tserver.render_chat(messages, template, jinja) == \
            jserver.render_chat(messages, template, jinja)
    prompt, stop = tserver.render_chat(MESSAGES, TINY_TEMPLATE)
    assert prompt == "<t3><t11><t5><t7><t12>" and stop == "<t11>"
    assert tserver.render_chat(MESSAGES)[1] == "### Human:"
    assert tserver.render_chat(MESSAGES, None, JINJA) == \
        ("<t2><t3><t2><t5><t7><t3>", "")
    assert tserver.DEFAULT_CHAT_TEMPLATE == jserver.DEFAULT_CHAT_TEMPLATE


@pytest.mark.parametrize("jinja", [
    "{{ raise_exception('nope') }}", "{% for %}", "{{ messages.x.y }}"],
    ids=["raise", "syntax", "undefined"])
def test_chat_template_failures_are_value_errors(jinja):
    for render in (tserver.render_chat, jserver.render_chat):
        with pytest.raises(ValueError):
            render([{"role": "user", "content": "x"}], None, jinja)


def _engine_text(model, prompt, n):
    """The port's engine run directly with the server's temperature-0
    sampler."""
    engine = Engine(model, max_streams=1, kv_dtype=torch.float32, n_batch=8)
    rid = engine.submit(GenerationRequest(
        prompt=prompt, max_tokens=n,
        sampler=tserver.sampler_from_params({"temperature": 0},
                                            n_vocab=model.spec.n_vocab)))
    while engine.has_work():
        engine.step()
    return "".join(engine.finished[rid].text)


def test_chat_completions(servers, models):
    """The reference's content; equal to /v1/completions on the rendered
    prompt with the user prefix as a stop; two choices."""
    js, ts = servers
    body = {"messages": MESSAGES, "max_tokens": 6, "temperature": 0,
            "chat_template": TINY_TEMPLATE, "logit_bias": NO_EOT}
    _, ref = _post(js, body, "/v1/chat/completions")
    status, got = _post(ts, body, "/v1/chat/completions")
    assert status == 200
    assert got["object"] == "chat.completion"
    assert got["id"].startswith("chatcmpl-")
    choice = got["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["message"] == ref["choices"][0]["message"]
    assert choice["finish_reason"] == ref["choices"][0]["finish_reason"]
    prompt, stop = tserver.render_chat(MESSAGES, TINY_TEMPLATE)
    direct = _engine_text(models[1], prompt, 6)
    cut = direct.split(stop)[0]
    assert choice["message"]["content"] == cut.rstrip()
    _, comp = _post(ts, {"prompt": prompt, "max_tokens": 6,
                         "temperature": 0, "stop": [stop],
                         "logit_bias": NO_EOT})
    assert comp["choices"][0]["text"].rstrip() == \
        choice["message"]["content"]
    # `n` choices: greedy, so both equal; the short path works too
    _, two = _post(ts, dict(body, n=2), "/chat/completions")
    assert [c["index"] for c in two["choices"]] == [0, 1]
    assert {c["message"]["content"] for c in two["choices"]} == \
        {choice["message"]["content"]}


def test_chat_completions_stream_delta(servers):
    js, ts = servers
    body = {"messages": [{"role": "user", "content": "<t5>"}],
            "max_tokens": 4, "temperature": 0,
            "chat_template": TINY_TEMPLATE, "logit_bias": NO_EOT}
    deltas, finish = _chat_stream(ts, body)
    ref_deltas, ref_finish = _chat_stream(js, body)
    assert deltas == ref_deltas and finish == ref_finish
    assert deltas[0] and finish[0] in ("length", "stop")
    _, whole = _post(ts, body, "/v1/chat/completions")
    assert whole["choices"][0]["message"]["content"] == deltas[0].rstrip()


def test_chat_template_error_is_400(model_path):
    """A model's template that raises answers 400 on both servers, and the
    server goes on serving."""
    jm, tm = _load_j(model_path), _load_t(model_path)
    jm.chat_template = tm.chat_template = "{{ raise_exception('nope') }}"
    js = jserver.LlmServer(jm, JEngine(jm, max_streams=1,
                                       kv_dtype=jnp.float32, n_batch=8),
                           host="127.0.0.1", port=0)
    ts = tserver.LlmServer(tm, Engine(tm, max_streams=1,
                                      kv_dtype=torch.float32, n_batch=8),
                           host="127.0.0.1", port=0)
    js.start()
    ts.start()
    try:
        body = {"messages": [{"role": "user", "content": "<t5>"}],
                "max_tokens": 2, "temperature": 0}
        for srv in (js, ts):
            status, got = _post(srv, body, "/v1/chat/completions")
            assert status == 400 and "nope" in got["error"]
        status, _ = _post(ts, {"prompt": "<t5>", "max_tokens": 2,
                               "temperature": 0})
        assert status == 200
    finally:
        _stop_j(js)
        ts.shutdown()


def test_embeddings_endpoint(servers, models):
    js, ts = servers
    tm = models[1]
    body = {"input": ["<t5><t7>", "<t9>"]}
    status, got = _post(ts, body, "/v1/embeddings")
    _, ref = _post(js, body, "/v1/embeddings")
    assert status == 200 and got["object"] == "list"
    assert [d["index"] for d in got["data"]] == [0, 1]
    for g, r in zip(got["data"], ref["data"]):
        v = np.asarray(g["embedding"], np.float32)
        assert v.shape == (tm.spec.n_embd,)
        np.testing.assert_allclose(v, np.asarray(r["embedding"]), **TOL)
    session = InferenceSession(tm, InferenceSessionConfig())
    req = OutputRequest(embeddings=[])
    session.feed_prompt("<t5><t7>", output_request=req)
    want = np.asarray(req.embeddings, np.float32).reshape(
        -1, tm.spec.n_embd)[-1]
    np.testing.assert_allclose(got["data"][0]["embedding"], want, **TOL)
    # a single string is one input; an untokenizable one is a 400 on both
    status, one = _post(ts, {"input": "<t9>"}, "/embeddings")
    assert status == 200
    assert one["data"][0]["embedding"] == got["data"][1]["embedding"]
    for srv in (js, ts):
        assert _post(srv, {"input": "zzz"}, "/v1/embeddings")[0] == 400


def test_gguf_chat_template_loads(tmp_path, model_path):
    """A GGUF file's tokenizer.chat_template (written by the port's
    gguf-convert) is the model's template and drives the chat route, with
    the reference's text."""
    from llm_tpu_torch.cli import main as t_main

    dst = tmp_path / "m.gguf"
    t_main(["gguf-convert", str(model_path), str(dst), "-a", "llama",
            "--chat-template", JINJA])
    tm = _load_t(dst)
    assert tm.chat_template == JINJA
    jm = _load_j(dst)
    srvs = []
    try:
        for m, srv_cls, eng in (
                (jm, jserver.LlmServer,
                 lambda: JEngine(jm, max_streams=1, kv_dtype=jnp.float32,
                                 n_batch=8)),
                (tm, tserver.LlmServer,
                 lambda: Engine(tm, max_streams=1, kv_dtype=torch.float32,
                                n_batch=8))):
            m.chat_template = JINJA
            srvs.append(srv_cls(m, eng(), host="127.0.0.1", port=0))
            srvs[-1].start()
        body = {"messages": [{"role": "user", "content": "<t5>"}],
                "max_tokens": 3, "temperature": 0, "logit_bias": NO_EOT}
        (_, ref), (status, got) = (_post(s, body, "/v1/chat/completions")
                                   for s in srvs)
        assert status == 200
        assert got["choices"][0]["message"]["content"]
        assert got["choices"] == ref["choices"]
    finally:
        _stop_j(srvs[0])
        if len(srvs) > 1:
            srvs[1].shutdown()
    convert_ggml_to_gguf(model_path, tmp_path / "plain.gguf", "llama")
    assert _load_t(tmp_path / "plain.gguf").chat_template is None


def test_checkpoint_without_snapshot_is_409(servers):
    for srv in servers:
        status, body = _post(srv, {}, "/admin/checkpoint")
        assert status == 409 and body["status"] == "error"
        assert "no snapshot path" in body["error"]
        assert _post(srv, [1], "/admin/checkpoint")[0] == 400


def _wait(cond, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("timed out")
        time.sleep(0.02)


def test_engine_snapshot_lifecycle(models, tmp_path):
    """A live /admin/checkpoint (200; 409 outside the snapshot's
    directory, as the reference answers), the final checkpoint on
    shutdown, and a restore at start whose stream finishes headless with
    the uninterrupted run's text."""
    tm = models[1]
    path = str(tmp_path / "serve.ckpt")
    srv = tserver.LlmServer(tm, Engine(tm, max_streams=2,
                                       kv_dtype=torch.float32, n_batch=8),
                            host="127.0.0.1", port=0, engine_snapshot=path)
    srv.start()
    try:
        status, _ = _post(srv, {"prompt": "<t5><t7>", "max_tokens": 6,
                                "temperature": 0})
        assert status == 200
        status, body = _post(srv, {}, "/admin/checkpoint")
        assert (status, body) == (200, {"status": "ok", "path": path})
        assert os.path.exists(path)
        other = str(tmp_path / "other.ckpt")
        assert _post(srv, {"path": other}, "/admin/checkpoint")[0] == 200
        outside = str(tmp_path.parent / "elsewhere.ckpt")
        status, body = _post(srv, {"path": outside}, "/admin/checkpoint")
        assert status == 409 and "snapshot directory" in body["error"]
        assert not os.path.exists(outside)
        os.remove(path)
    finally:
        srv.shutdown()
    assert os.path.exists(path)  # written on shutdown

    # the reference's server answers the same codes
    jm = models[0]
    jsrv = jserver.LlmServer(jm, JEngine(jm, max_streams=2,
                                         kv_dtype=jnp.float32, n_batch=8),
                             host="127.0.0.1", port=0,
                             engine_snapshot=str(tmp_path / "j.ckpt"))
    jsrv.start()
    try:
        assert _post(jsrv, {}, "/admin/checkpoint")[0] == 200
        assert _post(jsrv, {"path": outside}, "/admin/checkpoint")[0] == 409
    finally:
        _stop_j(jsrv)

    eng2 = Engine(tm, max_streams=2, kv_dtype=torch.float32, n_batch=8)
    rid = eng2.submit(GenerationRequest(prompt="<t2><t3>", max_tokens=6,
                                        sampler=DeterministicSampler()))
    eng2.step()
    write_engine(eng2, path)
    while eng2.has_work():
        eng2.step()
    expect = "".join(eng2.finished[rid].text)

    eng3 = Engine(tm, max_streams=2, kv_dtype=torch.float32, n_batch=8)
    srv2 = tserver.LlmServer(tm, eng3, host="127.0.0.1", port=0,
                             engine_snapshot=path)
    assert eng3.active == 1  # restored before the loop starts
    srv2.start()
    try:
        _wait(lambda: rid in eng3.finished)
        assert "".join(eng3.finished[rid].text) == expect
        status, _ = _post(srv2, {"prompt": "<t5>", "max_tokens": 4,
                                 "temperature": 0})
        assert status == 200
    finally:
        srv2.shutdown()


def test_corrupt_engine_snapshot_quarantined(models, tmp_path):
    tm = models[1]
    path = str(tmp_path / "corrupt.ckpt")
    eng = Engine(tm, max_streams=2, kv_dtype=torch.float32, n_batch=8)
    eng.submit(GenerationRequest(prompt="<t2>", max_tokens=4,
                                 sampler=DeterministicSampler()))
    eng.step()
    write_engine(eng, path)
    data = bytearray(open(path, "rb").read())
    rng = random.Random(3)
    for _ in range(64):  # trash the payload
        data[rng.randrange(9, len(data))] = rng.randrange(256)
    open(path, "wb").write(bytes(data[: len(data) * 2 // 3]))

    fresh = Engine(tm, max_streams=2, kv_dtype=torch.float32, n_batch=8)
    srv = tserver.LlmServer(tm, fresh, host="127.0.0.1", port=0,
                            engine_snapshot=path)
    assert not os.path.exists(path)
    assert os.path.exists(path + ".corrupt")
    assert fresh.active == 0
    srv.start()
    try:
        status, body = _post(srv, {"prompt": "<t5>", "max_tokens": 4,
                                   "temperature": 0})
        assert status == 200 and body["choices"][0]["text"]
    finally:
        srv.shutdown()


def test_build_engine_restores(models, tmp_path):
    tm = models[1]
    eng = Engine(tm, max_streams=2, kv_dtype=torch.float32, n_batch=8)
    eng.submit(GenerationRequest(prompt="<t2><t3>", max_tokens=5,
                                 sampler=DeterministicSampler()))
    eng.step()
    path = tmp_path / "b.ckpt"
    write_engine(eng, path)
    built = tserver.build_engine(tm, max_streams=2, kv_dtype=torch.float32,
                                 n_batch=8, engine_snapshot=path)
    assert built.active == 1 and built._next_id == eng._next_id


def test_cli_serve_engine_snapshot(model_path, tmp_path):
    """`serve --engine-snapshot PATH --device cpu` serves, and on SIGINT
    writes its final checkpoint; a second start restores it."""
    path = tmp_path / "cli.ckpt"
    for attempt in range(2):
        proc = subprocess.Popen(
            [sys.executable, "-m", "llm_tpu_torch", "serve", "-m",
             str(model_path), "-a", "llama", "--num-ctx-tokens", str(CTX),
             "--max-streams", "2", "--port", "0", "--no-warmup",
             "--engine-snapshot", str(path), "--device", "cpu"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        seen = []
        try:
            while not seen or "serving" not in seen[-1]:
                seen.append(lines.get(timeout=120))
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
        while not lines.empty():
            seen.append(lines.get())
        assert any("engine checkpoint on shutdown: ok" in x for x in seen)
        assert path.exists()
        if attempt == 1:
            assert any("restored engine state" in x for x in seen)
