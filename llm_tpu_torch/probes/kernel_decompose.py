"""P2: where the scalar qmatmul kernel's time goes on the card, stage by
stage.

The port of `scripts/probe_kernel_decompose.py` (its Pallas kernels,
`make_probe` and `run_chain`). Four variants over the same Q4_0 planes,
each with the scalar kernel's grid and K split (`qmatmul_probe.plan`) at
decode shape (M=8, K=R=4096), stacked over L layers:

    stream   every weight word the kernel loads (lo and scale), summed
    unpack   + the nibble extraction
    dequant  + zero point, scale and the bf16 rounding
    full     + x staging and the FMAs: the scalar kernel whole

All four are `ops/qmatmul_probe.py`'s launches (csrc/qmatmul_probe.cu: the
scalar kernel of csrc/qmatmul_body.cuh, whole or cut after a stage), the
design the probe was written to decompose; the production kernel is now
the tensor-core one (csrc/qmatmul_tc.cuh), which P1 times. Reported as us a launch and GB/s of packed bytes
(lo + scale planes); the differences between rows locate the time.

Differences from the reference: its TPU tile arguments (`tile_r tile_k`)
are gone (the card's kernel has its own grid); the stack holds L=24 layers
so one pass reads 4x the 50 MB L2 (the reference's 4 layers, 38 MB, would
be read from the L2); M=8 runs in the kernel's 16-row tiles, half of them
padding. Timing is on the card (probes/common.py).

    python -m llm_tpu_torch.probes.kernel_decompose [--M 8] [--rounds 7]
"""

from __future__ import annotations

import numpy as np
import torch

from llm_tpu_torch.ops import qmatmul as qm
from llm_tpu_torch.ops import qmatmul_probe as qp
from llm_tpu_torch.probes import common

VARIANTS = ("stream", "unpack", "dequant", "full")
K = R = 4096
TINY = 256
L_MIN = 24
REPS = 4  # passes over the stack in one timed chain


def variant_plain(variant: str, x: torch.Tensor, w) -> torch.Tensor:
    """The plain version of a variant over one layer."""
    if variant == "full":
        return qm.qmatmul_plain(x, w)
    return qp.stage_plain(w, variant)


def variant_launch(variant: str, x: torch.Tensor, w):
    """The prepared launch of a variant over one layer, on the card."""
    if variant == "full":
        return qp.prepare_full(x, w)
    return qp.prepare_stage(w, variant, x.shape[0])


def run(device, M: int = 8, rounds: int = 7, tiny: bool = False) -> dict:
    """Build the stack, run every variant; on the card, time them."""
    k = r = TINY if tiny else K
    w = common.random_q4_0(k, r, 0, device)
    nbytes = sum(p.numel() * p.element_size() for p in (w.lo, w.scale))
    L = 2 if tiny else common.layers_for(nbytes, L_MIN)
    sq = common.stack(w, L)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (M, k)).astype(np.float32)).to(device)
    out = {"probe": "kernel_decompose", "device": str(device), "fmt": "q4_0",
           "K": k, "R": r, "M": M, "L": L, "mb_per_launch": nbytes / 1e6,
           "variants": {}}
    if device.type != "cuda":
        for v in VARIANTS:
            y = variant_plain(v, x, sq.layer(0))
            out["variants"][v] = {"us": None, "shape": list(y.shape)}
        return out
    chains = {v: [variant_launch(v, x, sq.layer(l)) for l in range(L)] * REPS
              for v in VARIANTS}
    timed, n_probe, n_qm = common.count_launches(
        lambda: common.time_chains(chains, rounds))
    for v in VARIANTS:
        t = timed[v]
        out["variants"][v] = {
            "us": t["us"], "gbps": nbytes / (t["us"] * 1e-6) / 1e9,
            "busy_share": t["busy_share"], "kernel_us": t["kernel_us"],
            "us_rounds": t["us_rounds"],
            "launches": (rounds + 2) * len(chains[v])}
    out.update(reps=REPS, rounds=rounds, card=common.card(),
               launches={"probe": n_probe, "qmatmul": n_qm})
    return out


def report(res: dict) -> None:
    common.print_table(
        f"\nP2 kernel_decompose: q4_0 K={res['K']} R={res['R']} M={res['M']}"
        f" L={res['L']} on {res['device']}",
        [(v, res["mb_per_launch"], d) for v, d in res["variants"].items()])
    common.emit(res)


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    ap.add_argument("--M", type=int, default=8, help="rows of x")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    report(run(dev, args.M, args.rounds, tiny=dev.type == "cpu"))


if __name__ == "__main__":
    main()
