"""P1: does the coalesced layout read faster than planes, and at which
tiling, on the card.

The port of `scripts/probe_coalesced.py` (its Pallas chains and the
stream-only kernel `make_stream_chain`). Q4_0 at a 7B FFN shape, `up`
(K=4096, R=11008) or `down` (K=11008, R=4096), M=8, stacked over L layers:

    plane        the production kernel over planes (K1; the tensor-core
                 kernel of csrc/qmatmul_tc.cuh, as are the K3 rows)
    coal2048     the kernel over the coalesced buffer (K3), the largest
                 legal tile_k <= 2048, coalesce_tiles' tile_r
    coalK        K3 at coalesce_tiles' own tiling (whole K), when it differs
    c_r512       K3, tile_k as coal2048, tile_r 512 (R packed to 1024s)
    c_r1024      the same at tile_r 1024
    cK_r512      K3 at whole K x 512 lanes
    dense        torch.matmul on a bf16 [Kp, Rp] weight: the yardstick, as
                 the reference's jnp.dot was (not a kernel of the port)
    <name>_stream  the stream cut of K3 (ops/qmatmul_probe.py) over each
                 coalesced buffer, on K3's plan at M=8: the main loop's
                 copies, waits and barriers and the words a thread's
                 dequant reads, summed; no dequant, no mma

The tiling changes only where the kernel finds a word on the card: every
128-column block still reads its columns' words, so the variants measure
the address pattern of the layout, not a TPU grid. GB/s are of the plane
layout's packed bytes, as in the reference, and `dense` of its bf16 bytes.
L defaults to 8, so one pass reads 4x the L2. Timing is on the card
(probes/common.py).

    python -m llm_tpu_torch.probes.coalesced [--shape up|down] [--variants ...]
"""

from __future__ import annotations

import numpy as np
import torch

from llm_tpu_torch.ops import qmatmul as qm
from llm_tpu_torch.ops import qmatmul_probe as qp
from llm_tpu_torch.ops.packing import (
    QuantTensorC,
    coalesce_qt,
    coalesced_seg_rows,
)
from llm_tpu_torch.probes import common

SHAPES = {"up": (4096, 11008), "down": (11008, 4096)}
TINY = {"up": (4096, 640), "down": (640, 512)}
L_MIN = 8
REPS = 8
M = 8
COALESCED = ("coal2048", "coalK", "c_r512", "c_r1024", "cK_r512")
DEFAULT_VARIANTS = "plane,coal2048,coalK,c_r512,c_r1024,cK_r512,dense"


def all_variants() -> list:
    return ["plane", *COALESCED, "dense", *(f"{n}_stream" for n in COALESCED)]


def build(K: int, R: int, seed: int, device) -> dict:
    """One layer of each weight: the planes (R packed to 128s), the wide
    planes (R packed to 1024s) and the coalesced buffers of the reference's
    tilings, by variant name."""
    qt = common.random_q4_0(K, R, seed, device)
    qt_w = common.random_q4_0(K, R, seed, device, r_multiple=1024)
    Kp = qt.k_padded
    tk_def, tr_def, _ = qm.coalesce_tiles(qt.fmt, Kp, qt.r_padded,
                                          qt.scale_packed)
    tk_small = next(
        tk for tk in range(min(2048, Kp), 63, -64)
        if Kp % tk == 0 and all(
            s % 8 == 0
            for s in coalesced_seg_rows(qt.fmt, tk, qt.scale_packed) if s))
    tiles = {"coal2048": (qt, tk_small, tr_def)}
    if tk_def != tk_small:
        tiles["coalK"] = (qt, tk_def, tr_def)
    for tr in (512, 1024):
        if qt_w.r_padded % tr == 0:
            tiles[f"c_r{tr}"] = (qt_w, tk_small, tr)
    if qt_w.k_padded == Kp:
        tiles["cK_r512"] = (qt_w, Kp, 512)
    weights = {"plane": qt}
    weights.update({n: coalesce_qt(w, tk, tr)
                    for n, (w, tk, tr) in tiles.items()})
    return weights


def _stacked(w, L: int):
    if isinstance(w, QuantTensorC):
        return QuantTensorC(w.fmt_name, w.k, w.r, w.kp, w.rp, w.tile_k,
                            w.tile_r, w.scale_packed,
                            torch.stack([w.buf] * L), w.splits)
    return common.stack(w, L)


def variant_weight(name: str, weights: dict):
    return weights[name.removesuffix("_stream")]


def variant_plain(name: str, x: torch.Tensor, w) -> torch.Tensor:
    """The plain version of a quantized variant over one layer."""
    if name.endswith("_stream"):
        return qp.stage_plain(w, "stream")
    return qm.qmatmul_plain(x, w)


def variant_launch(name: str, x: torch.Tensor, w):
    if name.endswith("_stream"):
        return qp.prepare_stage(w, "stream", x.shape[0], x)
    return qm.prepare(x, w)


def run(device, shape: str = "up", variants=None, rounds: int = 7,
        tiny: bool = False) -> dict:
    K, R = (TINY if tiny else SHAPES)[shape]
    weights = build(K, R, 0, device)
    qt = weights["plane"]
    plane_bytes = sum(p.numel() * p.element_size() for p in qt.planes()
                      if p is not None)
    Kp, Rp = qt.k_padded, qt.r_padded
    names = [v for v in (variants or all_variants())
             if v == "dense" or v.removesuffix("_stream") in weights]
    L = 2 if tiny else common.layers_for(plane_bytes, L_MIN)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (M, K)).astype(np.float32)).to(device)
    out = {"probe": "coalesced", "device": str(device), "fmt": "q4_0",
           "shape": shape, "K": K, "R": R, "Kp": Kp, "Rp": Rp, "M": M,
           "L": L, "tiles": {n: [w.tile_k, w.tile_r]
                             for n, w in weights.items()
                             if isinstance(w, QuantTensorC)},
           "variants": {}}
    mb = {n: (Kp * Rp * 2 if n == "dense" else plane_bytes) / 1e6
          for n in names}
    if device.type != "cuda":
        for n in names:
            if n == "dense":
                continue
            y = variant_plain(n, x, variant_weight(n, weights))
            out["variants"][n] = {"us": None, "mb": mb[n],
                                  "shape": list(y.shape)}
        return out
    stacks = {n: _stacked(w, L) for n, w in weights.items()
              if n in {v.removesuffix("_stream") for v in names}}
    chains = {}
    for n in names:
        if n == "dense":
            wd = torch.randn((L, Kp, Rp), device=device,
                             generator=torch.Generator(device).manual_seed(
                                 0)).bfloat16()
            xb = torch.zeros((M, Kp), dtype=torch.bfloat16, device=device)
            xb[:, :K] = x
            yd = torch.empty((M, Rp), dtype=torch.bfloat16, device=device)
            chains[n] = [(lambda l=l: torch.matmul(xb, wd[l], out=yd))
                         for l in range(L)] * REPS
            continue
        sw = stacks[n.removesuffix("_stream")]
        chains[n] = [variant_launch(n, x, sw.layer(l))
                     for l in range(L)] * REPS
    timed, n_probe, n_qm = common.count_launches(
        lambda: common.time_chains(chains, rounds))
    for n in names:
        t = timed[n]
        out["variants"][n] = {
            "us": t["us"], "mb": mb[n],
            "gbps": mb[n] * 1e6 / (t["us"] * 1e-6) / 1e9,
            "busy_share": t["busy_share"], "kernel_us": t["kernel_us"],
            "us_rounds": t["us_rounds"],
            "launches": 0 if n == "dense" else (rounds + 2) * len(chains[n])}
    out.update(reps=REPS, rounds=rounds, card=common.card(),
               launches={"probe": n_probe, "qmatmul": n_qm})
    return out


def report(res: dict) -> None:
    v = res["variants"]
    dense = v.get("dense", {}).get("gbps")
    common.print_table(
        f"\nP1 coalesced: q4_0 {res['shape']} K={res['K']} R={res['R']} "
        f"(padded {res['Kp']}x{res['Rp']}) M={res['M']} L={res['L']} on "
        f"{res['device']}; tiles {res['tiles']}",
        [(n, d["mb"], d) for n, d in v.items()],
        dense)
    common.emit(res)


def main(argv=None) -> None:
    ap = common.parser(__doc__)
    ap.add_argument("--shape", default="up", choices=sorted(SHAPES))
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma list; 'all' adds every <name>_stream")
    args = ap.parse_args(argv)
    dev = common.device_of(args)
    variants = (all_variants() if args.variants == "all"
                else args.variants.split(","))
    report(run(dev, args.shape, variants, args.rounds,
               tiny=dev.type == "cpu"))


if __name__ == "__main__":
    main()
