"""The port's tracing (llm_tpu_torch.trace) against the JAX package's
llm_tpu.trace: the same levels, the same stderr lines and report format,
spans named in a torch.profiler trace, and the session's `evaluate[n]`
span at level 2 as `llm_tpu/session.py` has it. Then what the port adds:
each closed span's record (nesting, the monotonic clock, a bounded
buffer), and the spans a session request opens."""

import json
import time

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
        with ttrace.span("outer"):
            with ttrace.span("boom"):
                raise ValueError
    assert ttrace.counts["boom"] == 1
    # both closed and recorded, the inner inside the outer
    boom, outer = ttrace.records()
    assert (boom.name, outer.name) == ("boom", "outer")
    assert outer.start <= boom.start <= boom.end <= outer.end
    with ttrace.span("after"):
        pass
    (after,) = ttrace.records(name="after")
    assert outer.end <= after.start


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


def test_records_nest_on_the_monotonic_clock():
    t0 = time.monotonic()
    with ttrace.span("request"):
        with ttrace.span("child", level=2):
            with ttrace.span("grandchild"):
                pass
        with ttrace.span("child", level=2):
            pass
    t1 = time.monotonic()
    with ttrace.span("next"):
        pass
    grand, c1, c2, req, nxt = ttrace.records()
    assert [r.name for r in (grand, c1, c2, req, nxt)] == [
        "grandchild", "child", "child", "request", "next"]
    assert t0 <= req.start <= c1.start <= grand.start <= grand.end
    assert grand.end <= c1.end <= c2.start <= c2.end <= req.end <= t1
    assert ttrace.records(name="child") == [c1, c2]
    assert ttrace.records(t0=c1.start, t1=c2.start) == [grand, c1, c2]
    assert ttrace.records(t0=t1) == [nxt] and req.end <= nxt.start
    ttrace.reset()
    assert ttrace.records() == []


def test_records_stay_bounded():
    for _ in range(ttrace.RECORDS_MAX + 5):
        with ttrace.span("many"):
            pass
    kept = ttrace.records()
    assert len(kept) == ttrace.RECORDS_MAX
    assert ttrace.counts["many"] == ttrace.RECORDS_MAX + 5
    # the newest are kept
    with ttrace.span("newest"):
        pass
    assert ttrace.records()[-1].name == "newest"
    assert len(ttrace.records()) == ttrace.RECORDS_MAX


def test_record_function_only_under_a_profiler(monkeypatch, tmp_path):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with ttrace.span("quiet"):
        pass
    assert opened == []
    with ttrace.profile(str(tmp_path / "prof")):
        with ttrace.span("loud"):
            pass
    assert opened == ["loud"]


def _tiny_session(tmp_path, n_batch):
    from llm_tpu_torch.session import InferenceSessionConfig

    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    model = tloader.load(path, "llama",
                         params=tloader.ModelParameters(context_size=32),
                         device="cpu")
    return model.start_session(InferenceSessionConfig(n_batch=n_batch))


def test_infer_device_spans(tmp_path):
    """A prompt of two chunks and an output of three blocks: one request
    holding one prefill with both chunks in it, then three blocks, each
    ending in its host tail, all inside the request."""
    sess = _tiny_session(tmp_path, n_batch=8)
    sess.infer_device(list(range(2, 12)), 12, n_steps=4, halt_on_eot=False)
    recs = ttrace.records()
    (req,) = [r for r in recs if r.name == "session.request"]
    (pre,) = [r for r in recs if r.name == "session.prefill"]
    chunks = [r for r in recs if r.name.startswith("evaluate[")]
    blocks = [r for r in recs if r.name == "session.block"]
    tails = [r for r in recs if r.name == "session.block.host"]
    assert len(recs) == 2 + len(chunks) + 2 * len(blocks)
    assert len(chunks) == 2 and len(blocks) == len(tails) == 3
    assert all(req.start <= r.start <= r.end <= req.end for r in recs)
    assert all(pre.start <= c.start <= c.end <= pre.end for c in chunks)
    assert pre.end <= blocks[0].start
    for b, h in zip(blocks, tails):
        # the tail closes the block: nothing of the block after it
        assert b.start <= h.start <= h.end <= b.end
        assert b.end - h.end < h.start - b.start
    assert [b.start for b in blocks] == sorted(b.start for b in blocks)


@pytest.mark.parametrize("entry", ["infer", "infer_device"])
def test_session_request_holds_its_prefill(tmp_path, entry):
    from llm_tpu_torch.session import InferenceRequest

    sess = _tiny_session(tmp_path, n_batch=8)
    if entry == "infer":
        sess.infer(InferenceRequest(prompt=[2, 3, 4],
                                    maximum_token_count=2),
                   rng=np.random.default_rng(0))
    else:
        sess.infer_device([2, 3, 4], 2, n_steps=2, halt_on_eot=False)
    (req,) = ttrace.records(name="session.request")
    (pre,) = ttrace.records(name="session.prefill")
    assert req.start <= pre.start <= pre.end <= req.end
