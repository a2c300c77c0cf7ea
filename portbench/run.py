"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell names a configuration (`portbench/configs/<config>.json`)
and a traffic mix (`portbench/traffic/<traffic>.json`), which names the
driver that puts it through the port (`portbench/drivers/<driver>.py`);
the configuration names its architecture (`portbench/archs/<arch>.py`,
with its plain reference in `portbench/reference/<arch>.py`) and its
block format (`portbench/formats/<format>.py`); the cell's limits are in
`portbench/limits/<cell>.json`, and each metric is read by
`portbench/metrics/<metric>.py` (`portbench/plugins.py` finds each file
by its name). A run:

1. set-up: builds the port's kernels once into the checkout's
   `build/kernels`, makes the checkpoint from the seed on the card, builds
   the port's model from it, and warms up: every graph key the traffic can
   reach is captured, then the traffic runs until every client's first
   request has ended;
2. measures for `--seconds` (with `--trace 1`, then profiles a short
   slice of more calls);
3. lets the window's requests finish, reads the card's memory peak, frees
   the program and holds a sample of the served tokens against the plain
   reference (`portbench/reference/`);
4. prints one JSON line: `correct`, `attempted`, `failed`, `metrics`
   (the cell's end-to-end metrics, or with `--trace 1` its per-layer
   ones), `device`, with `--trace 1` `breakdown`, and last `checks`, each
   number compared beside its limit (also the last lines on stderr).

It exits non-zero with no result where the card is missing, and where
JAX or the JAX package has been loaded in the process.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from statistics import median  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from portbench import plugins  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "llm_tpu")
HERE = Path(__file__).resolve().parent


def load_json(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def reader(name: str):
    """The `read(run)` function of portbench/metrics/<name>.py."""
    return plugins.load("metrics", name).read


def driver_class(name: str):
    """The `Driver` class of portbench/drivers/<name>.py."""
    return plugins.load("drivers", name).Driver


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cfg: dict, traffic: dict, limits: dict, metric_defs: list,
             seed: int, seconds: float, trace: bool, device,
             t_start: float = None, control: bool = False) -> dict:
    """One run of a cell on `device`; returns the result's fields. With
    `control`, `out["control"]` is also the control's reading on the same
    sample (portbench/control.py; a benchmark run never reads it)."""
    import torch

    from portbench import check, roofline
    from portbench.profile import profiled
    from portbench.traffic import RequestStream
    from portbench.weights import EOT_ID, build_model, make_checkpoint
    from portbench.window import Timeline, p95

    t_start = time.monotonic() if t_start is None else t_start
    dev = torch.device(device)
    torch.set_num_threads(4)
    if dev.type == "cuda":
        from llm_tpu_torch import _build

        torch.cuda.set_device(dev)
        _build.build(["qmatmul", "paged_attention", "codecs"])
        torch.cuda.reset_peak_memory_stats(dev)

    parts = {"start": time.monotonic() - t_start}
    t = time.monotonic()
    ckpt = make_checkpoint(cfg, seed, dev)
    parts["checkpoint"] = time.monotonic() - t
    model, load_s = build_model(cfg, ckpt, dev)
    if traffic["loop"] != "closed":
        raise ValueError("the drivers run closed loops only")
    settings = {**cfg[traffic["settings"]], **traffic.get("overrides", {})}
    requests = RequestStream(traffic, model.spec.n_vocab, seed)
    tl = Timeline()
    driver = driver_class(traffic["driver"])(model, settings, traffic,
                                             requests, tl)
    t = time.monotonic()
    keys = driver.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["warm"] = time.monotonic() - t

    tl.t_open = time.monotonic()
    setup_s = tl.t_open - t_start
    tl.t_end = driver.run_until(tl.t_open + seconds)
    calls = [c for c in driver.calls if tl.t_open < c[1] <= tl.t_end]
    work, prof = None, None
    if trace:
        work = roofline.Work()
        _, prof = profiled(lambda: [driver.call(work) for _ in
                                    range(traffic["trace_calls"])], dev)
    sample = tl.sample()
    t = time.monotonic()
    tl.t_cap = t + traffic["drain_cap_s"]
    driver.drain(tl.t_cap, sample)
    parts["drain"] = time.monotonic() - t
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    driver.free()
    del driver, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # what the window served, against the plain reference
    Reference = plugins.load("reference", cfg["arch"]).Reference
    banned = (EOT_ID,) if settings["ban_eot"] else ()
    picked = check.pick(sample, seed, traffic["check"]["requests"])
    gap, cmp = None, {}
    n_checked = sum(len(r.tokens) for r in picked)
    if picked:
        cmp = check.compare(
            Reference(ckpt.hp, ckpt.tensors, dev), picked, banned,
            Reference(ckpt.hp, ckpt.tensors, dev, "fp8") if control else None)
        gap = cmp["max_gap"]
    parts["check"] = time.monotonic() - t - parts["drain"]
    failed = len(tl.failed())
    checks = {
        "max_logit_gap": {"value": gap, "limit": limits["max_logit_gap"]},
        "failed_requests": {"value": failed, "limit": 0},
        "tokens_checked": {"value": n_checked,
                           "limit": traffic["check"]["min_tokens"]},
    }
    correct = (gap is not None and gap <= limits["max_logit_gap"]
               and failed == 0
               and n_checked >= traffic["check"]["min_tokens"])

    shape = plugins.arch(cfg["arch"]).shape_of(cfg, ckpt.hp)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    run = SimpleNamespace(
        tl=tl, calls=calls, trace=prof, work=work,
        shape=shape, peaks=roofline.peaks(kind), setup_s=setup_s,
        load_s=load_s, driver=traffic["driver"], p95=p95)
    metrics = {}
    for m in metric_defs:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(sample),
           "failed": failed, "metrics": metrics, "device": device_info}
    if prof is not None:
        device_info["busy_s"] = prof.busy_s()
        device_info["window_s"] = prof.window_s
        top = sorted(prof.time_by_name().items(), key=lambda kv: -kv[1])
        out["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in top[:10]],
            "idle_gaps": [[n[:160], s] for n, s in prof.idle_gaps(10)]}
    out["info"] = {"graph_keys_warmed": keys, "set_up_parts_s": parts,
                   "calls_in_window": len(calls),
                   "requests_checked": len(picked),
                   "ttft_ms_median": median(tl.ttft_ms() or [0.0]),
                   "tpot_ms_median": median(tl.tpot_ms() or [0.0])}
    if control:
        served = [t for r in picked for t in r.tokens]
        out["control"] = {"max_logit_gap": cmp.get("control_gap"),
                          "median_top2_margin": cmp.get("median_margin"),
                          "distinct_served_share":
                              len(set(served)) / max(1, len(served))}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    cfg = load_json("configs", f"{cell['config']}.json")
    traffic = load_json("traffic", f"{cell['traffic']}.json")
    limits = load_json("limits", f"{cell['name']}.json")

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    section = "per_layer" if args.trace else "end_to_end"
    result = run_cell(cfg, traffic, limits,
                      cell_metrics(bench, section, cell["name"]), args.seed,
                      args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
