"""P3: the qmatmul kernel with other dequant arithmetic, on the card.

The port of `scripts/probe_dequant_variants.py` (its Pallas kernels,
`make_call`). Q4_0 at the 7B FFN shape K=4096, R=11008 (packed at a
1024-multiple, 11264), coalesced whole-K x 512 lanes, M=8, stacked over L
layers. Every mode is K1's swapped kernel (`qmm_swapped` at 8 tokens a
block, on K1's plan: csrc/qmatmul_probe.cu over csrc/qmatmul_tc.cuh) with
another arithmetic in its dequant and products (ops/qmatmul_probe.py):

    base      K1: the field ORed into 2^23's mantissa, one f32 multiply by
              scale * 2^-p, bf16 -> mma.sync (bf16 x bf16, f32 accumulate)
    bf16      bf16x2 arithmetic: (128 + q) from the bits, minus 136, times
              the bf16 scale (no f32 step) -> mma.sync
    f32dot    x and w unrounded: x as three bf16 terms, w as two, five
              mma.sync a k-step (the tensor cores have no f32 product)
    ghoist    the tile holds q - zero (exact); a 32-group's two k16
              products into a partial, then acc += scale * partial (the
              form a tensor-core design takes: scale on the partials)
    noscale   no scale multiply (wrong numbers: the scaling's cost)
    nounpack  no field extraction (wrong numbers: the unpack's cost)
    stream    the loads alone (the stream cut over the same buffer)

`gdot` only moved x's grouping out of the TPU kernel; here it runs ghoist
and is reported as ghoist. `dimsem` was only a Mosaic hint; here it runs
base and is reported as base. The TPU's sub-slicing (`_subN`) is gone. L
defaults to 8, so one pass reads 4x the L2. Timing is on the card
(probes/common.py).

    python -m llm_tpu_torch.probes.dequant_variants [--modes ...] [--rounds 7]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from llm_tpu_torch.ops import qmatmul_probe as qp
from llm_tpu_torch.ops.packing import coalesce_qt
from llm_tpu_torch.probes import common

K, R = 4096, 11008
TINY_K, TINY_R = 1024, 512
L_MIN = 8
REPS = 8
M = 8
MODES = ("base", "bf16", "f32dot", "ghoist", "noscale", "nounpack", "stream")
ALIASES = {"gdot": "ghoist", "dimsem": "base"}
DEFAULT_MODES = "base,bf16,f32dot,ghoist,stream"  # the reference's default


def mode_names(spec: str) -> list:
    """The modes a --modes list asks for, aliases resolved, each once."""
    out = []
    for m in spec.split(","):
        m = ALIASES.get(m, m)
        if m not in MODES:
            raise ValueError(f"unknown mode {m!r} (modes: {MODES}, aliases: "
                             f"{ALIASES})")
        if m not in out:
            out.append(m)
    return out


def build(k: int, r: int, seed: int, device):
    """One layer's coalesced buffer: whole K x 512 lanes over planes padded
    to a 1024-multiple of R."""
    w = common.random_q4_0(k, r, seed, device, r_multiple=1024)
    return coalesce_qt(w, w.k_padded, 512)


def mode_plain(mode: str, x: torch.Tensor, qtc) -> torch.Tensor:
    if mode == "stream":
        return qp.stage_plain(qtc, "stream")
    return qp.mode_plain(x, qtc, mode)


def mode_launch(mode: str, x: torch.Tensor, qtc):
    if mode == "stream":
        return qp.prepare_stage(qtc, "stream", x.shape[0], x)
    return qp.prepare_mode(x, qtc, mode)


def run(device, modes=MODES, rounds: int = 7, tiny: bool = False) -> dict:
    k, r = (TINY_K, TINY_R) if tiny else (K, R)
    one = build(k, r, 0, device)
    nbytes = one.buf.numel() * 4
    L = 2 if tiny else common.layers_for(nbytes, L_MIN)
    qtc = dataclasses.replace(one, buf=torch.stack([one.buf] * L))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (M, k)).astype(np.float32)).to(device)
    out = {"probe": "dequant_variants", "device": str(device), "fmt": "q4_0",
           "K": k, "R": r, "Kp": qtc.kp, "Rp": qtc.rp, "M": M, "L": L,
           "tile_k": qtc.tile_k, "tile_r": qtc.tile_r,
           "mb_per_launch": nbytes / 1e6, "modes": {}}
    if device.type != "cuda":
        for m in modes:
            y = mode_plain(m, x, qtc.layer(0))
            out["modes"][m] = {"us": None, "shape": list(y.shape)}
        return out
    chains = {m: [mode_launch(m, x, qtc.layer(l)) for l in range(L)] * REPS
              for m in modes}

    def measure():
        timed = common.time_chains(chains, rounds)
        return timed, {m: chains[m][0]().clone() for m in modes}

    (timed, ys), n_probe, _ = common.count_launches(measure)
    base = ys.get("base")
    for m in modes:
        t = timed[m]
        rec = {"us": t["us"], "gbps": nbytes / (t["us"] * 1e-6) / 1e9,
               "busy_share": t["busy_share"], "kernel_us": t["kernel_us"],
            "us_rounds": t["us_rounds"],
               "launches": (rounds + 2) * len(chains[m]) + 1}
        if base is not None and m not in ("base", "stream"):
            rec["rel_err_vs_base"] = float(
                (ys[m] - base).abs().max() / (base.abs().max() + 1e-9))
        out["modes"][m] = rec
    out.update(reps=REPS, rounds=rounds, card=common.card(),
               launches={"probe": n_probe})
    return out


def report(res: dict) -> None:
    common.print_table(
        f"\nP3 dequant_variants: q4_0 K={res['K']} R={res['R']} (padded "
        f"{res['Kp']}x{res['Rp']}) tile ({res['tile_k']},{res['tile_r']}) "
        f"M={res['M']} L={res['L']} on {res['device']}",
        [(m, res["mb_per_launch"], d) for m, d in res["modes"].items()])
    for m, d in res["modes"].items():
        if "rel_err_vs_base" in d:
            print(f"  {m}: rel err vs base {d['rel_err_vs_base']:.2e}")
    common.emit(res)


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    ap.add_argument("--modes", default=DEFAULT_MODES)
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    report(run(dev, mode_names(args.modes), args.rounds,
               tiny=dev.type == "cpu"))


if __name__ == "__main__":
    main()
