"""The control's readings, and the program's, for setting a cell's limit.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

runs the cell once a seed, all in one process, as `run.py` does, and
after each run reads on the same sample both the program's number (the
widest gap of a served token below the reference's best) and the
control's: the reference computed in the precision one step below the
configuration's (each matmul's activations in float8 e4m3 with a scale a
row, weights in bf16), reading at each position the gap of the token the
control puts first. One JSON line a seed. The benchmark's runs never run
it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, cell_metrics, load_json, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = load_json("configs", f"{cell['config']}.json")
    traffic = load_json("traffic", f"{cell['traffic']}.json")
    limits = load_json("limits", f"{cell['name']}.json")
    for seed in args.seeds:
        t = time.monotonic()
        out = run_cell(cfg, traffic, limits,
                       cell_metrics(bench, "end_to_end", cell["name"]), seed,
                       args.seconds, False, "cuda:0", control=True)
        print(json.dumps({
            "workload": cell["name"], "seed": seed,
            "program": out["checks"]["max_logit_gap"]["value"],
            "control": out["control"]["max_logit_gap"],
            "median_top2_margin": out["control"]["median_top2_margin"],
            "distinct_served_share":
                out["control"]["distinct_served_share"],
            "tokens": out["checks"]["tokens_checked"]["value"],
            "correct": out["correct"], "seconds": time.monotonic() - t,
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
