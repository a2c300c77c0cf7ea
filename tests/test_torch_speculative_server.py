"""The port's speculative entry points against the JAX package's, on a tiny
LLaMA Q4_0 target (2 layers, seed 0) and a mismatched 1-layer draft (seed
7), context 64:

- `infer --draft-model` prints the reference cli's text and plain greedy
  `infer`'s (`topk:k=1` with the repetition slot off), `--stats` reports
  `draft_acceptance`, and the flags the reference refuses with a draft
  model are refused before the model loads;
- `LlmServer` over each speculative engine answers temperature-0
  completions with the reference server's text and the plain engine's
  greedy text (the GreedySampler), refuses sampled requests on a
  greedy-only engine per request, and gives a sampled engine's requests a
  device sampler (an omitted temperature means 1.0); `build_engine` picks
  the four engines;
- `serve --draft-model` (`--draft-sampled`) starts from the command line
  on the CPU and answers a completion.

Texts are compared exactly (greedy tokens are equal on the f32 CPU path,
test_torch_speculative.py)."""

import json
import queue
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from llm_tpu import server as jserver
from llm_tpu import speculative as jsp
from llm_tpu.cli import main as j_main
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import server as tserver
from llm_tpu_torch import speculative as tsp
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.samplers import GreedySampler
from llm_tpu_torch.serve import Engine as TEngine
from llm_tpu_torch.serve import GenerationRequest as TReq
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
CTX = 64


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec_server")
    make_tiny_file("llama", d / "target.bin", GgmlType.Q4_0, seed=0)
    make_tiny_file("llama", d / "draft.bin", GgmlType.Q4_0, seed=7,
                   n_layer=1)
    return d / "target.bin", d / "draft.bin"


@pytest.fixture(scope="module")
def models(paths):
    def both(path):
        return (j_load(path, "llama",
                       params=JModelParameters(context_size=CTX)),
                tloader.load(path, "llama",
                             params=tloader.ModelParameters(context_size=CTX),
                             device="cpu"))

    (jt, tt), (jd, td) = both(paths[0]), both(paths[1])
    return {"jax": (jt, jd), "torch": (tt, td)}


# -- infer --draft-model -----------------------------------------------------


def _infer(main, paths, capsys, *flags, device=True):
    base = ["infer", "-m", str(paths[0]), "-a", "llama", "-p", "<t2><t3>",
            "-n", "8", "--num-ctx-tokens", str(CTX)]
    main(base + (["--device", "cpu"] if device else []) + list(flags))
    out = capsys.readouterr()
    # the paths render BOS (<t1>) differently: the per-token echo prints
    # it, the whole-sequence decode skips id 1
    return out.out.strip().replace("<t1>", ""), out.err


def test_cli_draft_model_matches_plain_greedy_and_reference(paths, capsys):
    got, err = _infer(t_main, paths, capsys, "--draft-model", str(paths[1]),
                      "--stats")
    plain, _ = _infer(t_main, paths, capsys, "-s", "topk:k=1",
                      "-s", "repetition:penalty=1.0")
    ref, _ = _infer(j_main, paths, capsys, "--draft-model", str(paths[1]),
                    device=False)
    assert got == plain == ref
    assert got.startswith("<t2><t3>") and got.count("<t") > 2 + 4
    assert "draft_acceptance:" in err and "predict_tokens: 8" in err


@pytest.mark.parametrize("flags", [
    ["-s", "topk:k=1"], ["--device-sampling"], ["--token-bias", "0=-1"],
    ["--ignore-eos"], ["--save-session", "s.bin"],
    ["--load-session", "s.bin"], ["--persist-session", "s.bin"],
])
def test_cli_draft_model_refusals(tmp_path, capsys, flags):
    """Refused before the load: the model path does not even exist."""
    with pytest.raises(SystemExit) as e:
        t_main(["infer", "-m", str(tmp_path / "missing.bin"), "-a", "llama",
                "-p", "<t2>", "--draft-model", str(tmp_path / "d.bin"),
                "--device", "cpu", *flags])
    assert e.value.code == 1
    assert "--draft-model" in capsys.readouterr().err


# -- the server --------------------------------------------------------------


def _post(srv, body):
    host, port = srv.address
    req = urllib.request.Request(
        f"http://{host}:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["choices"][0]


def _serving(srv):
    srv.start()
    srv.warmup()
    return srv


def _stop(srv, jax_side: bool):
    if jax_side:
        srv.httpd.shutdown()
        srv.loop.shutdown()
        srv.loop.join(timeout=60)
    else:
        srv.shutdown()
        assert not srv.loop.is_alive()


def _plain_text(model, prompt):
    """The plain engine's pure greedy text (the server's temperature 0
    keeps the host chain's repetition slot; a greedy-only engine does
    not)."""
    engine = TEngine(model, max_streams=1, kv_dtype=torch.float32,
                     n_batch=8)
    return engine.generate_all([TReq(prompt=prompt, max_tokens=8,
                                     sampler=GreedySampler())])[0]


ENGINES = [("SpeculativeEngine", {}), ("SampledSpeculativeEngine", {}),
           ("PagedSpeculativeEngine", {"page_size": 16}),
           ("PagedSampledSpeculativeEngine", {"page_size": 16,
                                              "prefix_cache": True})]
PROMPTS = ["<t5><t7>", "<t9><t4><t4><t2>"]


@pytest.mark.parametrize("cls,kw", ENGINES, ids=[e[0] for e in ENGINES])
def test_server_over_speculative_engine(models, cls, kw):
    jt, jd = models["jax"]
    tt, td = models["torch"]
    srvs = {
        "torch": tserver.LlmServer(tt, getattr(tsp, cls)(
            tt, td, k=3, max_streams=2, kv_dtype=torch.float32, n_batch=8,
            **kw), host="127.0.0.1", port=0),
        "jax": jserver.LlmServer(jt, getattr(jsp, cls)(
            jt, jd, k=3, max_streams=2, kv_dtype=jnp.float32, n_batch=8,
            **kw), host="127.0.0.1", port=0),
    }
    try:
        for s in srvs.values():
            _serving(s)
        for prompt in PROMPTS:
            body = {"prompt": prompt, "max_tokens": 8, "temperature": 0}
            texts = {k: _post(s, body)["text"] for k, s in srvs.items()}
            assert texts["torch"] == texts["jax"] == _plain_text(tt, prompt)
            assert texts["torch"].count("<t") == 8
        engine = srvs["torch"].loop.engine
        assert engine.drafted > 0
        sampled = {"prompt": "<t5>", "max_tokens": 4, "temperature": 0.8,
                   "top_k": 20, "seed": 1}
        if engine.greedy_only:
            # refused per request; the engine goes on serving
            assert _post(srvs["torch"], sampled)["finish_reason"] \
                .startswith("error")
        else:
            # the second body omits temperature (1.0 by default); a sampled
            # EoT ends a stream early, so the rule is stated, not the seed's
            # draw: a "length" finish has all 4 tokens, any other is EoT's
            # "stop" with fewer
            eot = tt.eot_token_id()
            for body in (sampled, {"prompt": "<t5>", "max_tokens": 4,
                                   "seed": 52}):
                choice = _post(srvs["torch"], body)
                n = choice["text"].count("<t")
                fin = engine.finished[max(engine.finished)]
                if choice["finish_reason"] == "length":
                    assert n == 4
                else:
                    assert choice["finish_reason"] == "stop" and n < 4
                    assert fin.finish_reason == "eot"
                    assert fin.tokens[-1] == eot
            assert fin.request.device_sampler.temperature == 1.0
        assert _post(srvs["torch"], {"prompt": "<t5>", "max_tokens": 2,
                                     "temperature": 0})["text"]
    finally:
        for k, s in srvs.items():
            _stop(s, k == "jax")


@pytest.mark.parametrize("paged,sampled,kv", [
    (False, False, None), (False, True, "int8"), (True, False, "int4"),
    (True, True, None)])
def test_build_engine_picks_speculative_engine(models, paged, sampled, kv):
    tt, td = models["torch"]
    e = tserver.build_engine(tt, max_streams=2, kv_dtype=kv, n_batch=8,
                             paged=paged, page_size=16, draft=td, draft_k=3,
                             draft_sampled=sampled)
    name = (("Paged" if paged else "") + ("Sampled" if sampled else "")
            + "SpeculativeEngine")
    assert type(e) is getattr(tsp, name)
    assert e.k == 3 and e.draft is td
    assert e.d_cache.k.dtype == (torch.int8 if kv in ("int8", "int4")
                                 else torch.bfloat16)


@pytest.mark.parametrize("flags", [[], ["--draft-sampled", "--paged",
                                        "--page-size", "16"]])
def test_cli_serve_draft_model_on_cpu(paths, flags):
    """`serve --draft-model ... --device cpu` starts, warms up, answers a
    completion, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch", "serve", "-m",
         str(paths[0]), "-a", "llama", "--num-ctx-tokens", str(CTX),
         "--draft-model", str(paths[1]), "--draft-k", "3",
         "--max-streams", "2", "--batch-size", "8", "--port", "0",
         "--device", "cpu", *flags],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = ""
        while "serving" not in line:
            line = lines.get(timeout=120)  # raises queue.Empty on a hang
        assert "draft k=3" in line
        url = line.split(" on ")[1].split()[0]
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps(
                {"prompt": "<t5><t7>", "max_tokens": 8,
                 "temperature": 0}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            text = json.loads(r.read())["choices"][0]["text"]
        assert text.count("<t") == 8
    finally:
        proc.terminate()
        proc.wait(timeout=60)
