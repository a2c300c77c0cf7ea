"""The port's tracing (llm_tpu_torch.trace) against the JAX package's
llm_tpu.trace: the same levels, the same stderr lines and report format,
spans named in a torch.profiler trace, and the session's `evaluate[n]`
span at level 2 as `llm_tpu/session.py` has it."""

import json

import numpy as np
import pytest
import torch

import llm_tpu.trace as jtrace
import llm_tpu_torch.trace as ttrace
from llm_tpu.ggml.types import GgmlType
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.testing import make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def clean():
    levels = (jtrace._LEVEL, ttrace._LEVEL)
    jtrace.reset()
    ttrace.reset()
    yield
    jtrace.set_level(levels[0])
    ttrace.set_level(levels[1])
    jtrace.reset()
    ttrace.reset()


@pytest.mark.parametrize("level,span_level,logs", [
    (0, 1, False), (1, 1, True), (1, 2, False), (2, 2, True)])
def test_span_levels_match_reference(capsys, level, span_level, logs):
    for mod in (jtrace, ttrace):
        mod.set_level(level)
        assert mod.enabled(1) == (level >= 1)
        assert mod.enabled(2) == (level >= 2)
        with mod.span("block", level=span_level):
            pass
        err = capsys.readouterr().err
        assert ("[trace] block: " in err) == logs
        assert mod.counts["block"] == 1 and mod.totals["block"] >= 0


def test_report_format_matches_reference():
    for mod in (jtrace, ttrace):
        for _ in range(3):
            with mod.span("a"):
                pass
        with mod.span("b"):
            pass
    j, t = jtrace.report().splitlines(), ttrace.report().splitlines()
    assert [line.split(":")[0] for line in t] == ["a", "b"]
    for jl, tl in zip(j, t):
        # same fields; the times differ
        assert jl.split(" total ")[0] == tl.split(" total ")[0]
        assert jl.split("calls ")[1].split(",")[0] == \
            tl.split("calls ")[1].split(",")[0]
    ttrace.reset()
    assert ttrace.report() == ""


def test_span_accumulates_on_exception():
    with pytest.raises(ValueError):
        with ttrace.span("boom"):
            raise ValueError
    assert ttrace.counts["boom"] == 1


def test_profile_writes_chrome_trace_with_spans(tmp_path):
    with ttrace.profile(str(tmp_path / "prof")):
        with ttrace.span("named_block"):
            torch.ones(8) @ torch.ones(8)
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "named_block" in names


def test_session_evaluate_span(tmp_path, capsys):
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    model = tloader.load(path, "llama",
                         params=tloader.ModelParameters(context_size=32),
                         device="cpu")
    ttrace.set_level(2)
    sess = model.start_session()
    sess.feed_prompt([1, 2, 3])
    err = capsys.readouterr().err
    assert "[trace] evaluate[3]: " in err
    assert ttrace.counts["evaluate[3]"] == 1
    assert np.isfinite(sess.last_logits).all()
