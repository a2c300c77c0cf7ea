"""P2: where the qmatmul kernel's time goes on the card, stage by stage.

The port of `scripts/probe_kernel_decompose.py` (its Pallas kernels,
`make_probe` and `run_chain`). Four variants over the same Q4_0 planes at
K=R=4096, stacked over L layers, each on K1's own plan at M (consumer
path, tokens a block, K split: `qmatmul.plan`):

    stream   the main loop's copies (packed rows and x), waits and
             barriers, and every weight word a thread's dequant reads,
             summed
    unpack   + the field extraction
    dequant  + zero point, scale and the bf16 rounding
    full     + x's bf16 staging and the tensor-core products: K1 whole

The first three are cuts of the production kernels (ops/qmatmul_probe.py,
csrc/qmatmul_probe.cu over csrc/qmatmul_tc.cuh): `qmm_swapped` at M <= 32
(mma.sync; 8 tokens a block at M=8 and 1), `qmm_wgmma` at M > 32 (wgmma,
x by TMA; 256 tokens a block at M=512). `full` is `qmatmul.prepare`. A
cut keeps every copy, wait, barrier and fence of the loop and its trip
count, so the differences between rows are work: unpack - stream the
extraction, dequant - unpack the scaling and rounding (and, on the wide
path, the bf16 tile's stores), full - dequant what feeds the tensor
cores. Reported as us a launch and GB/s of packed bytes (lo + scale
planes).

Differences from the reference: its TPU tile arguments (`tile_r tile_k`)
are gone (the card's kernel has its own grid); the stack holds L=24 layers
so one pass reads 4x the 50 MB L2 (the reference's 4 layers, 38 MB, would
be read from the L2). Timing is on the card (probes/common.py).

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
        return qm.prepare(x, w)
    return qp.prepare_stage(w, variant, x.shape[0], x)


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
