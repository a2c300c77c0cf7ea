"""The run's last line: its keys, in the order the contract asks, the
metric readers BENCHMARK.json names, and a run that finds no card."""

import json
from pathlib import Path

import pytest

from portbench import run as run_mod
from portbench.profile import Trace
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_result_keys_and_order():
    defs = run_mod.cell_metrics(BENCH, "end_to_end", "falcon-7b.interactive")
    out = run_mod.run_cell(tiny.FALCON, tiny.INTERACTIVE, tiny.LIMITS, defs,
                           5, 1.0, False, "cpu")
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["metrics"]) == {m["name"] for m in defs}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)  # no NaN or infinity: a valid JSON line


def test_every_metric_has_a_reader_that_can_find_nothing():
    from types import SimpleNamespace

    from portbench.window import Timeline, p95

    empty = SimpleNamespace(tl=Timeline(), calls=[],
                            trace=None, work=None, shape=None, peaks=None,
                            setup_s=1.0, load_s=1.0, driver="none", p95=p95)
    for m in BENCH["per_layer"]:
        assert run_mod.reader(m["name"])(empty) is None or \
            m["name"] == "load.weights_s"
    for m in BENCH["end_to_end"]:
        assert callable(run_mod.reader(m["name"]))


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        mine = {m["name"] for m in run_mod.cell_metrics(
            BENCH, "end_to_end", cell["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = run_mod.cell_metrics(BENCH, "per_layer", cell["name"])
        assert layers
        for m in layers:
            assert m["moves"] in mine and m["moves"] in e2e


def test_busy_and_idle_of_a_trace():
    t = Trace(1.0, ops=[(0.0, 0.2, "a"), (0.1, 0.3, "b"),
                             (0.5, 0.6, "a")],
              host=[(0.0, 1.0, "step"), (0.25, 0.45, "aten::mul")])
    assert t.busy_s() == pytest.approx(0.4)
    gaps = t.idle_gaps()
    assert gaps[0] == ("step", pytest.approx(0.4))
    assert gaps[1] == ("aten::mul", pytest.approx(0.2))
    assert t.time_by_name()["a"] == pytest.approx(0.3)
    assert t.time_matching(("b",)) == pytest.approx(0.2)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run_mod.main(["--workload", "falcon-7b.interactive", "--seed",
                       "3", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    cell = {w["name"]: w for w in BENCH["workloads"]}["falcon-7b.interactive"]
    cfg = run_mod.load_json("configs", f"{cell['config']}.json")
    traffic = run_mod.load_json("traffic", f"{cell['traffic']}.json")
    limits = run_mod.load_json("limits", f"{cell['name']}.json")
    out = run_mod.run_cell(cfg, traffic, limits, run_mod.cell_metrics(
        BENCH, "end_to_end", cell["name"]), 2**31 + 3, BENCH["run_seconds"],
        False, card)
    assert out["correct"], out["checks"]


def test_every_cells_mix_names_a_driver():
    for cell in BENCH["workloads"]:
        t = run_mod.load_json("traffic", f"{cell['traffic']}.json")
        assert callable(run_mod.driver_class(t["driver"]))
