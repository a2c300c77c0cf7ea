"""The port's cli commands of the session surface against the JAX
package's cli, on a tiny LLaMA Q4_0 written by the JAX package's
`make_tiny_file` (context 64, greedy `topk:k=1`, f32 cache): `perplexity`,
`prompt-tokens`, `infer` on a GGUF file made by `gguf-convert`, `repl` and
`chat` on piped stdin (as tests/test_cli_interactive.py drives the
reference), and `infer --save-session` then `--load-session` (each
package's file read by the other) and `--persist-session`.

Each command's standard output equals the reference's, apart from
`perplexity`, whose printed values are held within rtol 1e-5
(test_torch_perplexity.py)."""

import io
import re

import numpy as np
import pytest
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

from llm_tpu.cli import main as j_main
from llm_tpu.ggml.types import GgmlType
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch.cli import main as t_main

CTX = ["--num-ctx-tokens", "64"]
GREEDY = ["-s", "topk:k=1", "--no-float16"]
DEV = ["--device", "cpu"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_cli_session") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    return path


def _both(capsys, argv, stdin=None, monkeypatch=None):
    """(port's stdout, reference's stdout) of one command line."""
    outs = []
    for main, extra in ((t_main, DEV), (j_main, [])):
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        main(argv + extra)
        outs.append(capsys.readouterr().out)
    return outs


def test_perplexity(model_path, capsys):
    text = "".join(f"<t{i}>" for i in
                   np.random.default_rng(2).integers(1, 96, 200))
    got, ref = _both(capsys, ["perplexity", "-m", str(model_path), "-a",
                              "llama", "-p", text, "--no-float16"] + CTX)
    pat = re.compile(r"Perplexity\[(\d+)\]: (\S+)")
    g, r = pat.findall(got), pat.findall(ref)
    assert [i for i, _ in g] == [i for i, _ in r] == ["0", "1", "2"]
    np.testing.assert_allclose([float(p) for _, p in g],
                               [float(p) for _, p in r], rtol=1e-5)


def test_prompt_tokens(model_path, capsys):
    got, ref = _both(capsys, ["prompt-tokens", "-m", str(model_path), "-a",
                              "llama", "-p", "<t5><t7><t9>"] + CTX)
    assert got == ref and "=== Dumping prompt tokens:" in got


def test_infer_on_converted_gguf(model_path, tmp_path, capsys):
    gguf = tmp_path / "llama.gguf"
    t_main(["gguf-convert", str(model_path), str(gguf), "-a", "llama"])
    got, ref = _both(capsys, ["infer", "-m", str(gguf), "-a", "llama", "-p",
                              "<t2><t3><t9>", "-n", "8", "--ignore-eos"]
                     + GREEDY + CTX)
    assert got == ref and got.count("<t") == 12  # BOS, 3, 8 new
    # the same text as the classic file's
    t_main(["infer", "-m", str(model_path), "-a", "llama", "-p",
            "<t2><t3><t9>", "-n", "8", "--ignore-eos"] + GREEDY + CTX + DEV)
    assert capsys.readouterr().out == got


@pytest.mark.parametrize("lines,template", [
    ("<t2><t3>\n<t9><t4>\n", None),
    ("<t9>\n", "<t5>{{PROMPT}}<t6>\n"),
    ("<t2>\\\n<t3>\n<t5>\n", None),  # a continued line, then one more
], ids=["two-lines", "template", "continuation"])
def test_repl(model_path, tmp_path, capsys, monkeypatch, lines, template):
    argv = ["repl", "-m", str(model_path), "-a", "llama", "-n", "4",
            "--seed", "1"] + GREEDY + CTX
    if template:
        (tmp_path / "template.txt").write_text(template)
        argv += ["-f", str(tmp_path / "template.txt")]
    got, ref = _both(capsys, argv, lines, monkeypatch)
    assert got == ref and got.count(">> ") >= 2


def test_chat(model_path, tmp_path, capsys, monkeypatch):
    prelude = tmp_path / "prelude.txt"
    prelude.write_text("<t5><t6>")
    argv = ["chat", "-m", str(model_path), "-a", "llama", "--seed", "1",
            "-f", str(prelude), "-p", "<t7>"] + GREEDY + CTX
    got, ref = _both(capsys, argv, "<t9>\n<t4><t8>\n", monkeypatch)
    assert got == ref and got.count(">> ") == 3


def test_save_then_load_session(model_path, tmp_path, capsys):
    base = ["infer", "-m", str(model_path), "-a", "llama", "-n", "4",
            "--ignore-eos"] + GREEDY + CTX
    t_main(base + ["-p", "<t2><t3><t9>", "--save-session",
                   str(tmp_path / "t.session")] + DEV)
    first = capsys.readouterr().out
    j_main(base + ["-p", "<t2><t3><t9>", "--save-session",
                   str(tmp_path / "j.session")])
    assert capsys.readouterr().out == first
    outs = {}
    for main, extra, name in ((t_main, DEV, "t"), (t_main, DEV, "j"),
                              (j_main, [], "t"), (j_main, [], "j")):
        main(base + ["-p", "<t5>", "--load-session",
                     str(tmp_path / f"{name}.session")] + extra)
        outs[(main is t_main, name)] = capsys.readouterr().out
    assert len(set(outs.values())) == 1, outs
    assert outs[(True, "j")].count("<t") == 5  # the prompt and 4 new


def test_persist_session(model_path, tmp_path, capsys):
    """The first run starts afresh and writes the file; the second
    continues from it."""
    runs = {}
    for main, extra, side in ((t_main, DEV, "t"), (j_main, [], "j")):
        path = tmp_path / f"{side}.session"
        for i, prompt in enumerate(("<t2><t3>", "<t7>")):
            main(["infer", "-m", str(model_path), "-a", "llama", "-n", "3",
                  "--ignore-eos", "-p", prompt, "--persist-session",
                  str(path)] + GREEDY + CTX + extra)
            runs[side, i] = capsys.readouterr().out
            assert path.exists()
    assert runs["t", 0] == runs["j", 0] and runs["t", 1] == runs["j", 1]
    assert runs["t", 1].startswith("<t7>")
