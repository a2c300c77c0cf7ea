"""The port's verification harness (`llm_tpu_torch/harness.py`) and its
`verify` command against the JAX package's:

- `run_arch` on the CPU passes the goldens of all seven
  `test_configs/*.json`, as they were recorded by the JAX package; the
  tiny models it writes are byte-equal to the reference harness's and go
  to a directory of their own;
- a GGUF file as `model_path` with an empty config (the real-file default
  cases, determinism only), as `verify -m <file>.gguf -a llama` runs it;
- tests/test_verify_kit.py's cases through the port's cli: a tiny "real"
  file passes, a wrong golden fails, checksummed downloads over file://
  URLs (reused, rejected, replaced), `--record` writes what the
  reference's `--record` writes and its replay passes, a corrupted golden
  fails, a url-pinned config stays canonical, and the perplexity gate.

The recorded perplexity is held within rtol 1e-5 of the reference's
(test_torch_perplexity.py); every other recorded value is equal."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

from llm_tpu import harness as jharness
from llm_tpu.cli import main as j_main
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import harness as tharness
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.ggml.gguf import convert_ggml_to_gguf

CONFIGS = Path(__file__).resolve().parent.parent / "test_configs"
ARCHS = sorted(p.stem for p in CONFIGS.glob("*.json"))
DEV = ["--device", "cpu"]
TEST_DIRS = (tharness.TEST_DIR, jharness.TEST_DIR)  # as the modules set them


@pytest.fixture(scope="module")
def test_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_verify_tests")


@pytest.fixture(autouse=True)
def private_test_dirs(test_dir, monkeypatch):
    """Each harness writes its tiny models and downloads under a test
    directory of this run."""
    monkeypatch.setattr(tharness, "TEST_DIR", test_dir / "torch")
    monkeypatch.setattr(jharness, "TEST_DIR", test_dir / "jax")


def test_port_keeps_its_own_test_dir():
    """Both suites may run their harness at once: the port's tiny models
    go under `.tests/torch/`, not the reference's `.tests/models/`."""
    assert tharness.DEFAULT_CONFIG_DIR == jharness.DEFAULT_CONFIG_DIR
    assert TEST_DIRS[0] == TEST_DIRS[1] / "torch"
    assert TEST_DIRS[1] == CONFIGS.parent / ".tests"


@pytest.mark.parametrize("arch", ARCHS)
def test_recorded_goldens_pass(arch, test_dir):
    assert len(ARCHS) == 7
    config = json.loads((CONFIGS / f"{arch}.json").read_text())
    report = tharness.run_arch(arch, CONFIGS, device="cpu")
    assert report.status == "ok", report.error
    got = {c.name: (c.status, c.message) for c in report.cases}
    assert set(got) == {"Hyperparameters", "CanSend"} | {
        list(c)[0] for c in config["test_cases"]}
    assert all(s == "passed" for s, _ in got.values()), got
    # the model the goldens were recorded on, byte for byte
    et = config.get("element_type", "q4_0")
    path = test_dir / "torch" / "models" / f"{arch}-{et}.bin"
    ref = jharness._ensure_model(config, arch)
    assert path.read_bytes() == ref.read_bytes()


def test_gguf_file_default_cases(tmp_path):
    src = tmp_path / "llama.bin"
    make_tiny_file("llama", src)
    dst = tmp_path / "llama.gguf"
    convert_ggml_to_gguf(src, dst, "llama")
    cfg = {"context_size": 64, "test_cases": [
        {"Inference": {"input": "<t2><t3>", "maximum_token_count": 8}},
        {"Tokens": {"input": "<t5><t7>"}}, {"Delete": {}}]}
    report = tharness.run_arch("llama", CONFIGS, config=cfg,
                               overrides={"model_path": str(dst)},
                               device="cpu")
    assert [(c.name, c.status) for c in report.cases] == [
        ("Hyperparameters", "passed"), ("CanSend", "passed"),
        ("Inference", "passed"), ("Tokens", "passed"), ("Delete", "passed")]


@pytest.fixture()
def real_file(tmp_path):
    path = tmp_path / "real-llama.bin"
    make_tiny_file("llama", path)
    return path


def _config(tmp_path, real_file, name="llama.json", **extra):
    cfg = {
        "architecture": "llama",
        "model_path": str(real_file),
        "context_size": 64,
        "test_cases": [
            {"Inference": {"input": "<t2><t3>", "maximum_token_count": 8}},
            {"Tokens": {"input": "<t5><t7>"}},
            {"Delete": {}},
        ],
        **extra,
    }
    p = tmp_path / name
    p.write_text(json.dumps(cfg))
    return p


def test_cli_verify_passes_on_a_real_file(tmp_path, real_file, capsys):
    cfg = _config(tmp_path, real_file)
    j_main(["verify", "--config", str(cfg)])
    ref = capsys.readouterr().out
    t_main(["verify", "--config", str(cfg)] + DEV)
    out = capsys.readouterr().out
    assert "PASS" in out and "Inference: passed" in out
    strip = [line.split(" (")[0] for line in out.splitlines()]
    assert strip == [line.split(" (")[0] for line in ref.splitlines()]


def test_cli_verify_fails_on_wrong_golden(tmp_path, real_file, capsys):
    cfg = _config(tmp_path, real_file)
    body = json.loads(cfg.read_text())
    body["test_cases"][1]["Tokens"]["output"] = 1  # a wrong argmax id
    cfg.write_text(json.dumps(body))
    with pytest.raises(SystemExit):
        t_main(["verify", "--config", str(cfg)] + DEV)
    out = capsys.readouterr().out
    assert "Tokens: failed" in out and "FAIL" in out


def test_download_with_checksum(tmp_path, real_file):
    sha = hashlib.sha256(real_file.read_bytes()).hexdigest()
    cfg = {"url": real_file.as_uri(), "filename": "dl.bin", "sha256": sha}
    p = tharness._ensure_model(cfg, "llama")
    assert p.exists() and p.read_bytes() == real_file.read_bytes()
    assert p.parent == tharness.TEST_DIR / "models"
    # cached with a matching checksum: no download, even from a dead url
    assert tharness._ensure_model(
        {**cfg, "url": "file:///nonexistent"}, "llama") == p


def test_download_rejects_bad_checksum(tmp_path, real_file):
    cfg = {"url": real_file.as_uri(), "filename": "dl2.bin",
           "sha256": "0" * 64}
    with pytest.raises(RuntimeError, match="sha256"):
        tharness._ensure_model(cfg, "llama")
    assert not (tharness.TEST_DIR / "models" / "dl2.bin").exists()


def test_stale_cache_redownloaded(tmp_path, real_file):
    models = tharness.TEST_DIR / "models"
    models.mkdir(parents=True, exist_ok=True)
    (models / "dl3.bin").write_bytes(b"corrupt")
    sha = hashlib.sha256(real_file.read_bytes()).hexdigest()
    p = tharness._ensure_model(
        {"url": real_file.as_uri(), "filename": "dl3.bin", "sha256": sha},
        "llama")
    assert p.read_bytes() == real_file.read_bytes()


def _cases(rec):
    return {list(c)[0]: c[list(c)[0]] for c in rec["test_cases"]}


def test_record_matches_reference_then_replays(tmp_path, real_file,
                                               capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("<t2><t3><t4><t5>" * 80)
    recs = {}
    for side, main, extra in (("jax", j_main, []), ("torch", t_main, DEV)):
        cfg = _config(tmp_path, real_file, name=f"{side}.json")
        main(["verify", "--config", str(cfg), "--record",
              "--ppl-corpus", str(corpus)] + extra)
        out = capsys.readouterr().out
        assert "recorded goldens ->" in out and "PASS" in out
        recs[side] = json.loads(cfg.read_text())
    t, j = recs["torch"], recs["jax"]
    tc, jc = _cases(t), _cases(j)
    np.testing.assert_allclose(tc["Perplexity"].pop("expected"),
                               jc["Perplexity"].pop("expected"), rtol=1e-5)
    assert tc == jc
    assert {k: v for k, v in t.items() if k != "test_cases"} == \
        {k: v for k, v in j.items() if k != "test_cases"}
    assert t["sha256"] == hashlib.sha256(real_file.read_bytes()).hexdigest()
    assert tc["Tokens"]["output_backend"] == "cpu"

    # the replay asserts the recorded goldens, and passes
    cfg = tmp_path / "torch.json"
    t_main(["verify", "--config", str(cfg)] + DEV)
    out = capsys.readouterr().out
    assert "PASS" in out and "failed" not in out
    # a corrupted golden fails the replay
    t = json.loads(cfg.read_text())
    t["test_cases"][1]["Tokens"]["output"] += 1
    cfg.write_text(json.dumps(t))
    with pytest.raises(SystemExit):
        t_main(["verify", "--config", str(cfg)] + DEV)
    assert "Tokens: failed" in capsys.readouterr().out


def test_record_requires_local_model(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"architecture": "llama"}))
    with pytest.raises(SystemExit, match="record"):
        t_main(["verify", "--config", str(cfg), "--record"] + DEV)


def test_record_keeps_url_canonical(tmp_path, real_file, capsys):
    cfg_path = tmp_path / "url.json"
    cfg_path.write_text(json.dumps({
        "architecture": "llama",
        "url": real_file.as_uri(),
        "filename": "url.bin",
        "sha256": None,
        "context_size": 64,
        "test_cases": [{"Tokens": {"input": "<t5><t7>"}}],
    }))
    t_main(["verify", "--config", str(cfg_path), "-m", str(real_file),
            "--record"] + DEV)
    capsys.readouterr()
    rec = json.loads(cfg_path.read_text())
    assert "model_path" not in rec
    assert rec["url"] == real_file.as_uri()
    assert rec["sha256"] == hashlib.sha256(
        real_file.read_bytes()).hexdigest()


def test_ppl_gate(tmp_path, real_file, capsys):
    from llm_tpu_torch.loader import ModelParameters, load
    from llm_tpu_torch.session import InferenceSession

    corpus = tmp_path / "corpus.txt"
    corpus.write_text("<t2><t3><t4><t5>" * 80)
    model = load(real_file, "llama", params=ModelParameters(context_size=64),
                 device="cpu")
    last = []
    InferenceSession(model).perplexity(corpus.read_text(),
                                       lambda i, p: last.append(p))
    measured = last[-1]
    cfg = _config(tmp_path, real_file)
    t_main(["verify", "--config", str(cfg), "--ppl-corpus", str(corpus),
            "--ppl-expected", str(measured)] + DEV)
    assert "Perplexity: passed" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        t_main(["verify", "--config", str(cfg), "--ppl-corpus", str(corpus),
                "--ppl-expected", str(measured / 2), "--ppl-tolerance",
                "0.1"] + DEV)
    assert "Perplexity: failed" in capsys.readouterr().out
