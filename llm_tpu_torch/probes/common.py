"""What the probes share: their arguments, random Q4_0 weights stacked
over layers, and device timing of a chain of prepared launches.

Timing. A chain is a list of prepared launches (`_build.Launch`, or any
callable that enqueues work), one per layer of a stack, repeated. It runs
after a spin kernel long enough for the host to enqueue the whole chain
before the card reaches it; CUDA events around the chain, over the count,
give the card's time a launch. The stacks hold enough layers that one pass
reads at least 4x the H100's 50 MB L2, so each launch reads its weight from
device memory, as the main path does. torch.profiler traces one more run of
every chain: the card's busy share between a chain's first and last kernel
says whether the reading is the card's (near 1) or the host's. The
reference's chains fed each result into the next step (`h = h + y * 1e-6`)
to stop XLA hoisting the call; eager CUDA launches need no such guard.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from llm_tpu_torch.ggml.quant import quantize
from llm_tpu_torch.ggml.types import GgmlType
from llm_tpu_torch.ops.packing import QuantTensor, pack_ggml
from llm_tpu_torch.testing import _random_scalar_quant

L2_BYTES = 50e6  # H100 L2
HOST_US_PER_LAUNCH = 40.0  # what the spin lets the host enqueue, generous
CLOCK_HZ = 1.98e9  # H100 SXM boost clock: spin cycles per second


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): time the kernels on the card; "
                         "cpu: run the plain versions at a tiny size (a "
                         "test of the entry point)")
    ap.add_argument("--rounds", type=int, default=7)
    return ap


def device_of(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions at a tiny size")
    return dev


def random_q4_0(K: int, R: int, seed: int, device,
                r_multiple: int = 128) -> QuantTensor:
    """Q4_0 planes of a random [K, R] weight: normal * 0.02, quantized;
    above 4M weights, random valid blocks (small f16 scales, random
    nibbles), which the host writes ~10x faster."""
    rng = np.random.default_rng(seed)
    n = K * R
    if n > 1 << 22:
        raw = _random_scalar_quant(rng, GgmlType.Q4_0, n)
    else:
        raw = quantize(GgmlType.Q4_0,
                       (rng.standard_normal(n) * 0.02).astype(np.float32))
    return pack_ggml(GgmlType.Q4_0, raw, (K, R), r_multiple=r_multiple,
                     device=device)


def stack(qt: QuantTensor, L: int) -> QuantTensor:
    """L copies of one layer's planes, stacked [L, ...] (distinct memory:
    a pass over the stack reads L layers' bytes)."""

    def st(p):
        return None if p is None else torch.stack([p] * L)

    return QuantTensor(qt.fmt_name, qt.k, qt.r, st(qt.lo), st(qt.hi),
                       st(qt.scale), st(qt.bias), qt.splits)


def layers_for(bytes_per_layer: int, floor: int) -> int:
    """Layers in a stack: at least `floor`, and a pass over at least 4x
    the L2."""
    return max(floor, int(np.ceil(4 * L2_BYTES / bytes_per_layer)))


def _spin(n_launches: int) -> None:
    torch.cuda._sleep(int(n_launches * HOST_US_PER_LAUNCH * 1e-6 * CLOCK_HZ))


def time_chains(chains: dict, rounds: int) -> dict:
    """{name: {"us": median us a launch, "us_rounds": [...], "busy_share",
    "kernel_us"}} of each chain (see trace_chains); rounds interleave the
    chains, in a rotated order."""
    names = list(chains)
    for name in names:  # warm-up: first launches, allocator
        for f in chains[name]:
            f()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    order = list(names)
    for _ in range(rounds):
        for name in order:
            chain = chains[name]
            _spin(len(chain))
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for f in chain:
                f()
            e.record()
            torch.cuda.synchronize()
            times[name].append(s.elapsed_time(e) * 1e3 / len(chain))
        order = order[1:] + order[:1]
    traced = trace_chains(chains)
    return {n: {"us": statistics.median(times[n]), "us_rounds": times[n],
                **traced[n]} for n in names}


def trace_chains(chains: dict) -> dict:
    """One more run of each chain under torch.profiler, a session each: the
    card's busy share between the chain's first and last kernel, and the
    kernels' own time a launch (the sum of their durations over the
    chain's length); None where the profiler saw no kernel. The spin kernel
    before the chain is left out; a first spin, synchronized, lets the
    tracer start before the chain (a session's first kernel can be lost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, chain in chains.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _spin(1)
            torch.cuda.synchronize()
            _spin(len(chain))
            for f in chain:
                f()
            torch.cuda.synchronize()
        ivs = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "spin" not in e.name)
        if not ivs:
            out[name] = {"busy_share": None, "kernel_us": None}
            continue
        busy, reach = 0.0, float("-inf")  # union of the intervals
        for start, end in ivs:
            busy += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        span = max(e for _, e in ivs) - ivs[0][0]
        out[name] = {"busy_share": busy / span if span > 0 else None,
                     "kernel_us": sum(e - s for s, e in ivs) / len(chain)}
    return out


def count_launches(run) -> tuple:
    """(result of run(), probe-kernel launches it made, qmatmul launches
    it made)."""
    from llm_tpu_torch.ops import qmatmul as qm
    from llm_tpu_torch.ops import qmatmul_probe as qp

    p0, q0 = qp.LAUNCHES, qm.LAUNCHES
    out = run()
    return out, qp.LAUNCHES - p0, qm.LAUNCHES - q0


def print_table(title: str, rows: list, dense_gbps=None) -> None:
    """rows: (name, MB a launch, its timing dict: us, busy_share and
    kernel_us, the first None when not measured)."""
    print(title)
    print(f"{'variant':16} {'MB/launch':>10} {'us/launch':>10} "
          f"{'GB/s':>9} {'busy':>6} {'kernel us':>10}")
    for name, mb, t in rows:
        if t["us"] is None:
            print(f"{name:16} {mb:10.2f} {'not measured':>10}")
            continue
        gbps = mb * 1e6 / (t["us"] * 1e-6) / 1e9
        busy, k_us = t.get("busy_share"), t.get("kernel_us")
        b = "" if busy is None else f"{busy:6.3f}"
        k = "" if k_us is None else f"{k_us:10.2f}"
        print(f"{name:16} {mb:10.2f} {t['us']:10.2f} {gbps:9.1f} {b:>6} "
              f"{k:>10}")
    if dense_gbps:
        print("\nratios vs dense (GB/s of packed bytes over dense's GB/s):")
        for name, mb, t in rows:
            if t["us"] is not None and name != "dense":
                print(f"  {name:16} {mb * 1e3 / t['us'] / dense_gbps:.3f}")


def card() -> dict:
    """The card a reading comes from."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.splitlines()[0] if smi else None}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
