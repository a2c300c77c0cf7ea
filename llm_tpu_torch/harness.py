"""Integration-test harness: the analog of binaries/llm-test, on the port.

The counterpart of `llm_tpu/harness.py`: config-driven per-architecture
end-to-end runs with JSON reports (llm/binaries/llm-test/src/main.rs), on
the model's device (the card unless the caller asks for the CPU). Without
a `model_path` or `url` the harness synthesizes tiny checkpoints into
`.tests/torch/models/`, apart from the reference harness's
`.tests/models/` (both suites may run at once); a config may point
`model_path` at a real local GGML or GGUF file. Goldens carry the backend
they were recorded on under jax's names ("cpu", "gpu", "tpu"), a CUDA
device being "gpu", so a golden recorded by either package applies to
both on that backend. Test cases mirror llm-test:

- Inference (inference.rs): 128 tokens with the deterministic greedy
  never-repeat sampler; when the config carries an expected `output` string
  it is compared, otherwise two runs must agree (determinism).
- Tokens (tokens.rs): argmax of next-token logits equals a known id.
- Delete (delete.rs): rewind + refeed reproduces logits within epsilon.
- always-run: hyperparameter write/read round-trip (common.rs:3-30).

Run: python -m llm_tpu_torch.harness [arch ...] [--configs DIR]
[--device cpu]
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parent.parent
DEFAULT_CONFIG_DIR = REPO_ROOT / "test_configs"
TEST_DIR = REPO_ROOT / ".tests" / "torch"


@dataclass
class TestCaseReport:
    name: str
    status: str  # "passed" | "failed"
    message: str = ""
    duration_s: float = 0.0


@dataclass
class Report:
    architecture: str
    status: str = "ok"  # "ok" | "load_fail"
    error: str = ""
    cases: list = field(default_factory=list)
    # record mode only: the config with observed goldens + sha256 filled in
    recorded: Optional[dict] = None


def _sha256(path: Path, chunk: int = 1 << 22) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _download_model(config: dict, arch: str) -> Path:
    """Fetch a real checkpoint with progress + sha256 verification — the
    analog of llm-test's download path
    (llm/binaries/llm-test/src/main.rs:341-371), plus the
    checksum the reference lacks. A cached file is reused only when its
    checksum (if the config pins one) still matches; a checksum mismatch
    after download is an error, not a warning."""
    import urllib.request

    models = TEST_DIR / "models"
    models.mkdir(parents=True, exist_ok=True)
    path = models / config.get("filename", f"{arch}-real.bin")
    want = config.get("sha256")
    if path.exists():
        if not want or _sha256(path) == want:
            return path
        print(f"cached {path.name} fails its checksum; re-downloading",
              file=sys.stderr)
        path.unlink()
    url = config["url"]
    part = path.with_suffix(path.suffix + ".part")
    print(f"downloading {url} -> {path}", file=sys.stderr)
    # timeout: a mirror that accepts the connection but never sends data
    # must fail the arch with a report, not wedge the whole run
    with urllib.request.urlopen(url, timeout=120) as r, \
            open(part, "wb") as out:
        total = int(r.headers.get("Content-Length") or 0)
        done = 0
        while True:
            b = r.read(1 << 22)
            if not b:
                break
            out.write(b)
            done += len(b)
            if total:
                print(f"\r  {done / 1e6:.0f}/{total / 1e6:.0f} MB",
                      end="", file=sys.stderr)
        if total:
            print(file=sys.stderr)
    if want:
        got = _sha256(part)
        if got != want:
            part.unlink()
            raise RuntimeError(
                f"downloaded {url}: sha256 {got} != expected {want}"
            )
    part.rename(path)
    return path


def _ensure_model(config: dict, arch: str) -> Path:
    if config.get("model_path"):
        return Path(config["model_path"])
    if config.get("url"):
        return _download_model(config, arch)
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.testing import make_tiny_file

    et = GgmlType[config.get("element_type", "q4_0").upper()]
    models = TEST_DIR / "models"
    models.mkdir(parents=True, exist_ok=True)
    path = models / f"{arch}-{config.get('element_type', 'q4_0')}.bin"
    if not path.exists():
        make_tiny_file(arch, path, element_type=et, seed=config.get("seed", 0))
    return path


def _deterministic_generate(model, prompt: str, max_tokens: int) -> str:
    from llm_tpu_torch.samplers import DeterministicSampler
    from llm_tpu_torch.session import (
        EndOfText,
        InferenceParameters,
        InferenceRequest,
        InferenceSession,
        InferenceSessionConfig,
        ModelKVMemoryType,
    )

    session = InferenceSession(
        model,
        InferenceSessionConfig(
            memory_k_type=ModelKVMemoryType.Float32,
            memory_v_type=ModelKVMemoryType.Float32,
        ),
    )
    out = []
    session.infer(
        InferenceRequest(
            prompt=prompt,
            parameters=InferenceParameters(sampler=DeterministicSampler()),
            maximum_token_count=max_tokens,
        ),
        rng=np.random.default_rng(0),  # StepRng analog: fixed seed
        callback=lambda r: out.append(r.text),
    )
    return "".join(out)


def _backend(model) -> str:
    """The model's device under jax's backend name: a CUDA device is
    "gpu"."""
    kind = model.device.type
    return "gpu" if kind == "cuda" else kind


def _backend_matches(model, case: dict) -> bool:
    """Golden outputs are backend-specific (the card's matmuls run in
    bf16); only enforce them on the backend they were recorded on."""
    rec = case.get("output_backend")
    return rec is None or _backend(model) == rec


def case_inference(model, case: dict) -> None:
    prompt = case.get("input", "")
    max_tokens = case.get("maximum_token_count", 128)
    text1 = _deterministic_generate(model, prompt, max_tokens)
    expected = case.get("output")
    if expected is not None and _backend_matches(model, case):
        assert text1 == expected, f"expected {expected!r}, got {text1!r}"
    else:
        text2 = _deterministic_generate(model, prompt, max_tokens)
        assert text1 == text2, "deterministic generation did not reproduce"


def case_tokens(model, case: dict) -> None:
    from llm_tpu_torch.session import (
        InferenceSession,
        InferenceSessionConfig,
        ModelKVMemoryType,
    )

    session = InferenceSession(
        model,
        InferenceSessionConfig(memory_k_type=ModelKVMemoryType.Float32,
                               memory_v_type=ModelKVMemoryType.Float32),
    )
    session.feed_prompt(case.get("input", ""))
    got = int(np.argmax(session.last_logits))
    expected = case.get("output")
    if expected is not None and _backend_matches(model, case):
        assert got == expected, f"expected argmax {expected}, got {got}"
    else:
        session2 = InferenceSession(
            model,
            InferenceSessionConfig(memory_k_type=ModelKVMemoryType.Float32,
                                   memory_v_type=ModelKVMemoryType.Float32),
        )
        session2.feed_prompt(case.get("input", ""))
        assert got == int(np.argmax(session2.last_logits))


def case_delete(model, case: dict) -> None:
    from llm_tpu_torch.session import (
        InferenceSession,
        InferenceSessionConfig,
        ModelKVMemoryType,
    )

    if not model.supports_rewind:
        return
    session = InferenceSession(
        model,
        InferenceSessionConfig(memory_k_type=ModelKVMemoryType.Float32,
                               memory_v_type=ModelKVMemoryType.Float32),
    )
    tokens = [2, 5, 7, 9]
    session.feed_prompt(tokens)
    logits_before = session.last_logits.copy()
    session.feed_prompt([11, 13])
    session.rewind(2)
    session.feed_prompt([11, 13])
    session.rewind(2)
    # refeed the final prompt token to recompute last_logits at n_past-1
    session.rewind(1)
    session.feed_prompt([tokens[-1]])
    # epsilon like the reference's can_delete (llm-test delete.rs:24-55):
    # tight on the CPU (f32, reproducible); on the card the bf16 matmuls
    # of the chunked feed and of the refeed reduce in another order, so
    # the card's tolerance covers that and still catches a corrupt cache
    on_cpu = _backend(model) == "cpu"
    np.testing.assert_allclose(
        session.last_logits, logits_before,
        rtol=1e-5 if on_cpu else 1e-2,
        atol=1e-5 if on_cpu else 5e-3,
        err_msg="logits after rewind+refeed differ",
    )


def case_hyperparameters_roundtrip(model, case: dict) -> None:
    import io

    from llm_tpu_torch.models.spec import get_arch

    hp = model.hyperparameters
    buf = io.BytesIO()
    hp.write_ggml(buf)
    buf.seek(0)
    hp2 = get_arch(hp.arch).read_hparams(buf)
    hp2.n_head_kv = hp.n_head_kv  # runtime GQA override is not stored
    if model.container_type.kind == "gguf":
        # GGUF metadata holds fields the classic header has no room for
        # (context length, n_mult, rope settings), so the reference's
        # equality fails on every GGUF file for that alone: hold what the
        # header stores, which must encode to the same bytes again
        again = io.BytesIO()
        hp2.write_ggml(again)
        assert again.getvalue() == buf.getvalue(), (
            f"hyperparameters round-trip mismatch: {hp} -> {hp2}")
        return
    assert hp == hp2, f"hyperparameters round-trip mismatch: {hp} != {hp2}"


def case_can_send(model, case: dict) -> None:
    """The reference's always-run cross-thread test (llm-test
    common.rs:3-12): a loaded Model driven from another thread produces
    the same logits as this one."""
    import threading

    import numpy as np

    from llm_tpu_torch.session import InferenceSession

    ref = InferenceSession(model)
    ref.feed_prompt([2, 5, 3])
    expected = np.asarray(ref.last_logits)

    result: list = []

    def run():
        s = InferenceSession(model)
        s.feed_prompt([2, 5, 3])
        result.append(np.asarray(s.last_logits))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert result, "thread produced no logits"
    np.testing.assert_allclose(result[0], expected, rtol=1e-5, atol=1e-5)


def case_perplexity(model, case: dict) -> "float":
    """wikitext-2 (or any corpus) PPL through the device NLL pipeline —
    the +0.1-PPL parity oracle vs the reference's `llm perplexity`
    (llm/crates/llm-base/src/inference_session.rs:519-589).
    With `expected` set, ours must come in at most `tolerance` (default
    0.1) ABOVE it (lower is fine); without, the measured PPL is recorded
    in the report for manual comparison."""
    from llm_tpu_torch.session import (
        InferenceSession,
        InferenceSessionConfig,
        ModelKVMemoryType,
    )

    corpus = case.get("corpus")
    assert corpus, "Perplexity case needs a 'corpus' text-file path"
    text = Path(corpus).read_text()
    session = InferenceSession(
        model,
        InferenceSessionConfig(memory_k_type=ModelKVMemoryType.Float32,
                               memory_v_type=ModelKVMemoryType.Float32),
    )
    last: list = []
    session.perplexity(
        text,
        lambda i, p: (last.append(p),
                      print(f"  chunk {i}: ppl {p:.4f}", file=sys.stderr)),
    )
    assert last, "corpus shorter than one context window; nothing scored"
    ppl = last[-1]
    expected = case.get("expected")
    if expected is not None:
        tol = case.get("tolerance", 0.1)
        assert ppl <= expected + tol, (
            f"perplexity {ppl:.4f} exceeds expected {expected:.4f} "
            f"+ {tol} tolerance"
        )
    return ppl


CASE_RUNNERS = {
    "Hyperparameters": case_hyperparameters_roundtrip,
    "Inference": case_inference,
    "Tokens": case_tokens,
    "Delete": case_delete,
    "CanSend": case_can_send,
    "Perplexity": case_perplexity,
}


# --- golden recording (VERDICT r4 item 2: `cli verify --record`) ----------
#
# Egress is blocked in the build environment, so real-checkpoint goldens
# cannot be downloaded-and-asserted here. Recording inverts the flow: on the
# first machine that HAS the checkpoint file, each recorder runs the same
# code path as its assert-runner and writes the observed value INTO the case
# dict (plus the backend it was recorded on, since TPU bf16 matmuls may
# drift token-level goldens vs CPU f32). Reference analog: the
# `output_disabled` golden keys in the reference's own configs
# (llm/binaries/llm-test/configs/*.json).


def record_inference(model, case: dict) -> str:
    text = _deterministic_generate(
        model, case.get("input", ""), case.get("maximum_token_count", 128)
    )
    case["output"] = text
    case["output_backend"] = _backend(model)
    return text


def record_tokens(model, case: dict) -> int:
    from llm_tpu_torch.session import (
        InferenceSession,
        InferenceSessionConfig,
        ModelKVMemoryType,
    )

    session = InferenceSession(
        model,
        InferenceSessionConfig(memory_k_type=ModelKVMemoryType.Float32,
                               memory_v_type=ModelKVMemoryType.Float32),
    )
    session.feed_prompt(case.get("input", ""))
    got = int(np.argmax(session.last_logits))
    case["output"] = got
    case["output_backend"] = _backend(model)
    return got


def record_perplexity(model, case: dict) -> float:
    probe = {k: v for k, v in case.items() if k != "expected"}
    ppl = case_perplexity(model, probe)
    case["expected"] = round(float(ppl), 4)
    case.setdefault("tolerance", 0.1)
    return float(ppl)


CASE_RECORDERS = {
    "Inference": record_inference,
    "Tokens": record_tokens,
    "Perplexity": record_perplexity,
}


def run_arch(arch: str, config_dir: Path, overrides: Optional[dict] = None,
             extra_cases: Optional[list] = None,
             config: Optional[dict] = None, record: bool = False,
             device=None) -> Report:
    """Run (or, with record=True, record goldens for) one architecture's
    cases on `device` (default: the card). In record mode the
    golden-bearing cases write their observed outputs into the case dicts
    and `report.recorded` carries the updated config (incl. the model
    file's sha256) ready to be written back."""
    report = Report(architecture=arch)
    if config is None:
        config_path = config_dir / f"{arch}.json"
        config = (json.loads(config_path.read_text())
                  if config_path.exists() else {})
    else:
        config = dict(config)
    if overrides:
        config.update({k: v for k, v in overrides.items() if v is not None})

    real = bool(config.get("model_path") or config.get("url"))
    try:
        from llm_tpu_torch.loader import ModelParameters, load

        path = _ensure_model(config, arch)
        model = load(
            path, arch,
            params=ModelParameters(
                context_size=config.get("context_size",
                                        2048 if real else 64)
            ),
            device=device,
        )
    except Exception as e:
        report.status = "load_fail"
        report.error = f"{e}\n{traceback.format_exc()}"
        return report

    if real:
        # real checkpoints default to the reference harness's prompts
        # (binaries/llm-test/configs/*.json); synthetic tiny vocabs use
        # <tN> markers instead
        default_cases = [
            {"Inference": {"input": "When a llama rides a crab, ",
                           "maximum_token_count": 128}},
            {"Tokens": {"input": "Rustformers is"}},
            {"Delete": {}},
        ]
    else:
        default_cases = [
            {"Inference": {"input": "<t2><t3>", "maximum_token_count": 24}},
            {"Tokens": {"input": "<t5><t7>"}},
            {"Delete": {}},
        ]
    golden_cases = config.get("test_cases", default_cases) + (
        extra_cases or []
    )
    cases = [{"Hyperparameters": {}}, {"CanSend": {}}] + golden_cases
    if record:
        # the recorders mutate the case dicts in place; publish the
        # resulting config (goldens + artifact checksum) on the report
        config["test_cases"] = golden_cases
        config["sha256"] = _sha256(path)
        report.recorded = config
    for case in cases:
        (name, body), = case.items()
        runner = CASE_RUNNERS.get(name)
        if record and name in CASE_RECORDERS:
            runner = CASE_RECORDERS[name]
        if runner is None:
            # a typo'd / unknown case must be a visible failure, not a
            # silent fallback that reports the wrong test as "passed"
            report.cases.append(TestCaseReport(
                name, "failed", message=f"unknown test case {name!r}",
                duration_s=0.0,
            ))
            continue
        t0 = time.time()
        try:
            res = runner(model, body)
            msg = f"{res:.4f}" if isinstance(res, float) else ""
            if record and name in CASE_RECORDERS:
                msg = f"recorded: {res!r}"[:120]
            report.cases.append(
                TestCaseReport(
                    name, "passed", message=msg,
                    duration_s=time.time() - t0,
                )
            )
        except Exception as e:
            report.cases.append(
                TestCaseReport(
                    name, "failed", message=str(e), duration_s=time.time() - t0
                )
            )
    return report


def main(argv: Optional[list[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    from llm_tpu_torch.models.spec import SUPPORTED_ARCHITECTURES

    config_dir = DEFAULT_CONFIG_DIR
    if "--configs" in argv:
        i = argv.index("--configs")
        config_dir = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    archs = argv or list(SUPPORTED_ARCHITECTURES)

    results_dir = TEST_DIR / "results"
    results_dir.mkdir(parents=True, exist_ok=True)

    failed = False
    for arch in archs:
        report = run_arch(arch, config_dir, device=device)
        out = results_dir / f"{arch}.json"
        out.write_text(json.dumps(asdict(report), indent=2))
        ok = report.status == "ok" and all(
            c.status == "passed" for c in report.cases
        )
        failed |= not ok
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] {arch}: "
              + ", ".join(f"{c.name}={c.status}" for c in report.cases)
              + (f" ({report.error.splitlines()[0]})" if report.error else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
