"""The control comes out as not correct: the reference computed one
precision below the configuration's (activations in float8 e4m3, weights
in bf16), put in the program's place, at a size a test run holds. On the
card the same reading is taken at each cell's own size by
`portbench/control.py`."""

import json
from pathlib import Path

from portbench.run import run_cell
from portbench.tests import tiny

# the plain f32 path the port takes on the CPU serves the reference's own
# best tokens (gap 0 up to f32 rounding); the tiny control flips ties by
# 1e-3 and more (the cell's limit comes from its own chip readings)
LIMIT = {"max_logit_gap": 1e-5}


def test_control_fails_where_the_program_passes():
    traffic = {**tiny.INTERACTIVE,
               "check": {**tiny.INTERACTIVE["check"], "requests": 8}}
    out = run_cell(tiny.FALCON, traffic, LIMIT, [], 7, 2.0, False, "cpu",
                   control=True)
    assert out["correct"]
    assert out["checks"]["max_logit_gap"]["value"] <= LIMIT["max_logit_gap"]
    assert out["control"]["max_logit_gap"] > LIMIT["max_logit_gap"]


def test_each_cells_limit_lies_between_its_readings():
    root = Path(__file__).resolve().parent.parent
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        lim = json.loads((root / "limits" / f"{cell['name']}.json")
                         .read_text())
        low, high = lim["program_max"], lim["control_min"]
        assert high >= 3 * low
        assert low < lim["max_logit_gap"] < high
