"""The port's six other architectures against the JAX package through the
session and the CLI, on the tiny files of test_torch_archs.py (each
layout in Q4_0, Q5_1, Q8_0 and Q4_K): greedy `infer` gives the reference's
tokens and text, and the port's on-device decode loop (`infer_device`)
the same tokens; the CLI's `infer`, `infer --device-sampling` and `info`
with `-a` print what the reference's CLI prints. Tokens and text
identical."""

import numpy as np
import pytest
from test_torch_archs import (  # noqa: F401 (an autouse fixture)
    FORMATS,
    LAYOUTS,
    load_both,
    one_torch_thread,
    write_tiny,
)

from llm_tpu import session as jsession
from llm_tpu.cli import main as j_main
from llm_tpu.ggml.types import GgmlType
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu_torch import session as tsession
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.ops.sampling import DeviceSampler
from llm_tpu_torch.samplers import build_sampler_chain as t_chain

EOT = 0  # make_tiny_file's EoT token


@pytest.fixture(scope="module",
                params=[(lay, et) for lay in LAYOUTS for et in FORMATS],
                ids=[f"{lay[0]}-{et.name.lower()}" for lay in LAYOUTS
                     for et in FORMATS])
def models(request, tmp_path_factory):
    (name, arch, overrides), et = request.param
    path = tmp_path_factory.mktemp(f"torch_archs_infer_{name}") / "m.bin"
    write_tiny(arch, path, et, overrides)
    return load_both(path, arch)


def _greedy_infer(session_mod, model, chain, prompt, n):
    sess = session_mod.InferenceSession(model,
                                        session_mod.InferenceSessionConfig())
    texts = []

    def cb(r):
        if r.kind == "inferred_token":
            texts.append(r.text)
        return session_mod.InferenceFeedback.Continue

    req = session_mod.InferenceRequest(
        prompt=prompt, maximum_token_count=n,
        parameters=session_mod.InferenceParameters(sampler=chain))
    sess.infer(req, rng=np.random.default_rng(0), callback=cb)
    return sess.tokens, "".join(texts)
def test_greedy_infer_and_decode_loop(models):
    """Greedy `infer` (host sampling) gives the reference's tokens and text;
    the port's on-device decode loop gives the same tokens (blocks of 4;
    the device form of the host chain `topk:k=1`, whose default slots put
    a repetition penalty of 1.3 over 64 tokens before the top-k; EoT
    banned)."""
    jm, tm = models
    eot = [(EOT, float("-inf"))]
    prompt = list(np.random.default_rng(3).integers(1, 96, 19))
    jt, jtext = _greedy_infer(jsession, jm, j_chain(["topk:k=1"], bias=eot),
                              prompt, 12)
    tt, ttext = _greedy_infer(tsession, tm, t_chain(["topk:k=1"], bias=eot),
                              prompt, 12)
    assert len(tt) == 19 + 12
    assert tt == jt
    assert ttext == jtext and ttext

    sess = tsession.InferenceSession(tm, tsession.InferenceSessionConfig())
    sess.infer_device(prompt, 12, sampler=DeviceSampler(
        kind="greedy", repeat_penalty=1.3, penalty_last_n=64,
        bias=((EOT, float("-inf")),)), n_steps=4, halt_on_eot=False)
    assert sess.tokens == tt


# -- the CLI, one file an architecture --------------------------------------


@pytest.fixture(scope="module", params=LAYOUTS, ids=[l[0] for l in LAYOUTS])
def cli_file(request, tmp_path_factory):
    name, arch, overrides = request.param
    path = tmp_path_factory.mktemp(f"torch_archs_cli_{name}") / "m.bin"
    write_tiny(arch, path, GgmlType.Q4_0, overrides)
    return path, arch


@pytest.mark.parametrize("device_sampling", [False, True],
                         ids=["host", "device_sampling"])
def test_cli_infer_same_text(cli_file, capsys, device_sampling):
    path, arch = cli_file
    argv = ["infer", "-m", str(path), "-a", arch, "-p", "<t2><t3><t9>",
            "-n", "6", "--seed", "3", "-s", "topk:k=1", "--ignore-eos",
            "--num-ctx-tokens", "64"]
    if device_sampling:
        argv += ["--device-sampling", "--decode-steps", "4"]
    j_main(argv)
    ref = capsys.readouterr().out
    t_main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref
    # six generated tokens (host sampling echoes the prompt first)
    assert got.splitlines()[-1].count("<t") >= 6


def test_cli_info(cli_file, capsys):
    path, arch = cli_file
    j_main(["info", "-m", str(path), "-a", arch, "-t"])
    ref = capsys.readouterr().out
    t_main(["info", "-m", str(path), "-a", arch, "-t"])
    got = capsys.readouterr().out
    assert got == ref and "Tokenizer vocabulary size: 96" in got
