"""The span readers (`portbench/spans.py` and the six metrics over it) on
synthetic records and a synthetic profiled slice, on an empty run, on a
port that keeps no records, and in a CPU run of the tiny cell."""

import json
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import pytest

from llm_tpu_torch import trace
from llm_tpu_torch.trace import Record
from portbench import run as run_mod
from portbench.profile import Trace
from portbench.tests import tiny
from portbench.window import Timeline, p95

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("session.prefill_p95_ms", "session.block_host_share",
       "device.idle_prefill_share", "device.idle_blocks_share",
       "graphs.capture_s", "graphs.captures_in_window")
HOST_CLOCK = [m for m in BENCH["per_layer"]
              if m["name"] in NEW and m["source"] == "host_clock"]


def _request(t: float, prefill: float, blocks: list) -> list:
    """A request's records from time t: its prefill, then each block of
    (seconds, host tail seconds) after it."""
    out = [Record("session.prefill", t, t + prefill)]
    s = t + prefill
    for length, tail in blocks:
        out.append(Record("session.block", s, s + length))
        out.append(Record("session.block.host", s + length - tail, s + length))
        s += length
    out.append(Record("session.request", t, s))
    return out


# a window [100, 110] after a set-up of 20 s; a capture and a request of
# an earlier run in the same process before both, one after the window
RECORDS = (
    [Record("graph.capture", 70.0, 72.0)]
    + _request(75.0, 0.9, [(0.5, 0.1)])
    + [Record("graph.capture", 85.0, 87.0),
       Record("graph.capture", 90.0, 90.5)]
    + _request(95.0, 0.25, [(0.4, 0.05)])  # warm-up
    + _request(101.0, 0.3, [(0.3, 0.05), (0.4, 0.1)])
    + _request(103.0, 0.2, [(0.5, 0.05)])
    + [Record("graph.capture", 105.0, 105.25)]
    + _request(111.0, 0.4, [(0.5, 0.2)])  # the profiled slice
)

# the slice: a request over [0, 1.0] of 1.2 s; idle 0.1 s in the prefill,
# 0.15 + 0.05 s in the blocks, 0.2 s after the request
SLICE = Trace(1.2, ops=[(0.0, 0.1, "k"), (0.2, 0.4, "k"), (0.45, 0.6, "k"),
                        (0.5, 0.55, "k"), (0.7, 0.95, "k")],
              host=[(0.0, 1.0, "session.request"),
                    (0.0, 0.4, "session.prefill"),
                    (0.05, 0.2, "evaluate[512]"),
                    (0.4, 0.7, "session.block"),
                    (0.65, 0.7, "session.block.host"),
                    (0.7, 1.0, "session.block"),
                    (0.95, 1.0, "session.block.host")])

EXPECTED = {
    "session.prefill_p95_ms": p95([300.0, 200.0]),
    "session.block_host_share": 100.0 * (0.05 + 0.1 + 0.05) / (1.0 + 0.7),
    "device.idle_prefill_share": 100.0 * 0.1 / 1.2,
    "device.idle_blocks_share": 100.0 * 0.2 / 1.2,
    "graphs.capture_s": 2.5,
    "graphs.captures_in_window": 1,
}


def _run(driver="session", trace_=SLICE):
    return SimpleNamespace(
        tl=Timeline(t_open=100.0, t_end=110.0), calls=[], trace=trace_,
        work=None, shape=None, peaks=None, setup_s=20.0, load_s=1.0,
        driver=driver, p95=p95)


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(trace, "_records", deque(RECORDS))


def test_the_six_are_in_the_benchmark():
    mine = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert set(mine) == set(NEW)
    for m in mine.values():
        assert m["workloads"] == ["falcon-7b.interactive"]


@pytest.mark.parametrize("name", NEW)
def test_reader_on_synthetic_records(records, name):
    assert run_mod.reader(name)(_run()) == pytest.approx(EXPECTED[name])


def test_idle_inside_spans_adds_up_to_at_most_the_idle_share(records):
    run = _run()
    parts = sum(run_mod.reader(n)(run) for n in (
        "device.idle_prefill_share", "device.idle_blocks_share"))
    whole = run_mod.reader("device.idle_share")(run)
    assert whole == pytest.approx(100.0 * 0.5 / 1.2)
    assert parts <= whole


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing(records, name):
    """None on the empty run (no window, no slice), and on another driver
    where the span is the session's; the capture readers read any
    driver's captures."""
    read = run_mod.reader(name)
    empty = SimpleNamespace(tl=Timeline(), calls=[], trace=None, work=None,
                            shape=None, peaks=None, setup_s=1.0, load_s=1.0,
                            driver="none", p95=p95)
    assert read(empty) is None
    other = read(_run(driver="engine"))
    if name.startswith("graphs."):
        assert other == pytest.approx(EXPECTED[name])
    else:
        assert other is None


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_port_without_records(monkeypatch, name):
    """A port that keeps no records (or a slice without the port's span
    ranges) leaves every new metric out and raises nothing."""
    monkeypatch.delattr(trace, "records")
    bare = Trace(1.2, ops=SLICE.ops, host=[(0.05, 0.2, "evaluate[512]")])
    assert run_mod.reader(name)(_run(trace_=bare)) is None


def test_a_tiny_cell_reads_its_spans():
    out = run_mod.run_cell(tiny.FALCON, tiny.INTERACTIVE, tiny.LIMITS,
                           HOST_CLOCK, 2**31 + 11, 1.0, False, "cpu")
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"], out["checks"]
    assert got["session.prefill_p95_ms"] > 0
    assert 0 < got["session.block_host_share"] < 100
    assert got["graphs.captures_in_window"] == 0
    assert "graphs.capture_s" not in got  # the CPU captures nothing
