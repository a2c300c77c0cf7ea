"""Probe variants of the qmatmul kernel, for the chip probes of
`llm_tpu_torch.probes`: the counterparts of the TPU kernels of
`scripts/probe_kernel_decompose.py` (P2), `scripts/probe_coalesced.py`'s
stream-only pass (P1) and `scripts/probe_dequant_variants.py` (P3).

The CUDA is `csrc/qmatmul_probe.cu`: cuts and dequant modes of the
production tensor-core kernels of `csrc/qmatmul_tc.cuh` (`qmm_swapped`
for M <= 32, `qmm_wgmma` for M > 32). A probe launch runs `qmatmul.plan`'s
consumer path, tokens a block and K split at its M, with x staged as
`qmatmul.operands` stages it; K1 whole is `qmatmul.prepare` itself (P2's
`full`).

Stages, one value a column of the padded width Rp, for q4_0 and q8_0 with
f16-packed scales and q6_k, over planes or a coalesced buffer (P2's
stream / unpack / dequant, and P1's `<name>_stream`): the main loop cut
after a stage of each thread's 32 weights a k-tile. A cut keeps every copy
(the packed rows and x), wait, barrier and fence of the loop, and its trip
count; it drops what feeds only the tensor cores. x is copied and never
summed, so the values are the weight's:

    stream   wrapping uint32 sum of every word the kernel loads for the
             column: every lo word (a q8_0 plane's int8 sign-extended),
             every hi word, and per group of each 32-element unit its scale
             and bias word (a packed word serves two groups: counted twice)
    unpack   wrapping uint32 sum of every field q (hi bits included, zero
             point not subtracted) plus the same scale and bias words
    dequant  f32 sum over K of every weight rounded to bf16

The reference's stages kept their loads alive with a max over 8 elements;
the port's values depend on every word loaded, so the compiler drops no
load. stream and unpack are exact; dequant sums in another order than its
plain version: held to 1e-5 of the sum of |w| (f32 summation error over
at most 11264 terms). A cut's grid covers every column of Rp, where K1's
stops at R rounded to 128: a stage's value is defined on the padding too
(q4_0's padding fields are -8).

Modes, y [M, R] over a coalesced q4_0 buffer with f16-packed scales (the
reference probe's format), on the swapped path at 8 tokens a block (M <=
8; P3 runs M = 8): base (K1's arithmetic), bf16, f32dot, ghoist, noscale,
nounpack (`csrc/qmatmul_tc.cuh` Mode; noscale and nounpack are wrong on
purpose). They compute the reference probe's numbers for its modes of the
same names.

Each wrapper runs the plain version for a tensor on the CPU and the kernel
for one on the card, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ops import qmatmul as qm
from llm_tpu_torch.ops.packing import (
    FORMAT_IDS,
    QuantTensorC,
    _as_int32_bits,
    coalesced_word_planes,
    dequant,
    scale_plane_f32,
    uncoalesce_qt,
    unpack_q,
)

STAGES = {"stream": 1, "unpack": 2, "dequant": 3}
MODES = {"base": 0, "bf16": 1, "f32dot": 2, "ghoist": 3, "noscale": 4,
         "nounpack": 5}
# (format, f16-packed scales) the stage kernels are built for
STAGE_FORMATS = {("q4_0", True), ("q8_0", True), ("q6_k", False)}

LAUNCHES = 0  # probe kernel launches (stages, modes; plain not)

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "qmatmul_stage_launch": [_C, _C, _C, _C, _P, _C, _P, _P, _P, _P, _C,
                             _C, _C, _C, _C, _C, _C, _P, _P, _C, _C, _C, _C,
                             _C, _C, _C, _P],
    "qmatmul_mode_launch": [_C, _P, _C, _P, _P, _C, _C, _C, _C, _C, _C, _P,
                            _P, _C, _C, _C, _C, _C, _C, _C, _P],
}


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def _lib():
    return _build.load("qmatmul_probe", _SIGNATURES)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---------------------------------------------------------------------------
# stages


def _word_planes(w) -> list:
    """The int32 words the kernel loads, per segment (lo, hi, scale,
    bias): a coalesced buffer's own words, or the planes with f32 scales
    as their bits."""
    if isinstance(w, QuantTensorC):
        return coalesced_word_planes(w)
    return [None if p is None else
            (p.view(torch.int32) if p.dtype == torch.float32 else p)
            for p in w.planes()]


def stage_plain(w, stage: str) -> torch.Tensor:
    """The plain version of a stage over one layer of `w` (QuantTensor or
    QuantTensorC): [Rp] int32 bits (stream, unpack) or f32 (dequant)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    planes = uncoalesce_qt(w) if isinstance(w, QuantTensorC) else w
    if stage == "dequant":
        return dequant(planes, trim=False).bfloat16().float().sum(dim=-2)
    lo, hi, sc, bias = _word_planes(w)

    def total(p):
        return 0 if p is None else p.to(torch.int64).sum(dim=-2)

    reads = 2 if w.scale_packed else 1  # groups that read each scale word
    s = reads * (total(sc) + total(bias))
    if stage == "stream":
        s = s + total(lo) + total(hi)
    else:
        s = s + total(unpack_q(w.fmt, planes.lo, planes.hi))
    return _as_int32_bits(s & 0xFFFFFFFF)


def _check_stage(w, stage: str) -> None:
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if (w.fmt_name, w.scale_packed) not in STAGE_FORMATS:
        raise ValueError(f"stage kernels take {sorted(STAGE_FORMATS)}, not "
                         f"({w.fmt_name!r}, {w.scale_packed})")


def stage_buffers(w, stage: str, x: torch.Tensor, sms: int) -> tuple:
    """The plan and buffers of a stage launch over one layer of `w` with x
    [M, K] on x's device: (K1's plan at M on a card of `sms` SMs, x as the
    kernel reads it, the split scratch [splits, mtiles, Rp] and the output
    [Rp], both int32 for stream and unpack, f32 for dequant)."""
    _check_stage(w, stage)
    qm.check_k_tiles(w)
    p = qm.plan(w, x.shape[0], sms)
    xk, _, _ = qm.operands(x, w, p)
    dt = torch.float32 if stage == "dequant" else torch.int32
    part = torch.empty((p.splits, p.mtiles, w.r_padded), dtype=dt,
                       device=x.device)
    out = torch.empty(w.r_padded, dtype=dt, device=x.device)
    return p, xk, part, out


def prepare_stage(w, stage: str, M: int,
                  x: Optional[torch.Tensor] = None) -> _build.Launch:
    """The stage kernel over one layer of `w` on the card (not yet run),
    on the plan of K1 at M rows of x: `x` [M, K] (copied, never summed;
    zeros when None)."""
    _check_stage(w, stage)
    dev = w.device
    if x is None:
        x = torch.zeros((M, w.k), dtype=torch.float32, device=dev)
    if x.shape[0] != M:
        raise ValueError(f"x has {x.shape[0]} rows, not {M}")
    args = qm.weight_args(w, dev)
    p, xk, part, out = stage_buffers(w, stage, x, _sms(dev))
    return _build.Launch(
        _lib().qmatmul_stage_launch,
        (STAGES[stage], FORMAT_IDS[w.fmt_name], int(w.scale_packed),
         qm.PATHS[p.path], _build.ptr(xk), xk.shape[1], *args,
         _build.ptr(part), _build.ptr(out), M, w.k_padded, w.r_padded, p.bm,
         p.mtiles, p.splits, p.tiles_per_split),
        dev, "qmatmul_stage_launch", _count, out, (xk, part, w))


def stage_run(w, stage: str, M: int = 8) -> torch.Tensor:
    """A stage over one layer of `w`: its kernel for a weight on the card
    (K1's plan at M), else its plain version."""
    if w.device.type == "cuda":
        return prepare_stage(w, stage, M)()
    return stage_plain(w, stage)


# ---------------------------------------------------------------------------
# dequant modes


def _check_mode(qtc, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not isinstance(qtc, QuantTensorC) or qtc.fmt_name != "q4_0" or \
            not qtc.scale_packed:
        raise ValueError("the modes take a coalesced q4_0 weight with "
                         "f16-packed scales")


def mode_plain(x: torch.Tensor, qtc: QuantTensorC, mode: str) -> torch.Tensor:
    """The plain version of a mode: x [M, K] over one layer of a coalesced
    q4_0 weight -> y [M, R] f32, the reference probe's arithmetic."""
    _check_mode(qtc, mode)
    planes = uncoalesce_qt(qtc)
    q = unpack_q(qtc.fmt, planes.lo, None).float()  # centered: q - 8
    s = scale_plane_f32(planes.scale)  # [Kp/32, Rp]
    se = torch.repeat_interleave(s, 32, dim=0)
    xf = torch.nn.functional.pad(x.float(), (0, qtc.kp - qtc.k))
    xb = xf.bfloat16().float()
    if mode == "base":
        y = xb @ (q * se).bfloat16().float()
    elif mode == "bf16":
        y = xb @ (q.bfloat16() * se.bfloat16()).float()
    elif mode == "f32dot":
        y = xf @ (q * se)
    elif mode == "ghoist":
        G, M = qtc.kp // 32, x.shape[0]
        part = torch.einsum("mgj,gjr->gmr", xb.reshape(M, G, 32),
                            q.reshape(G, 32, -1))
        y = (part * s[:, None, :]).sum(dim=0)
    elif mode == "noscale":
        y = xb @ q
    else:  # nounpack: each lo word, as an int32, for all 8 of its fields
        words = torch.repeat_interleave(planes.lo.float(), 8, dim=0)
        y = xb @ (words * se).bfloat16().float()
    return y[:, : qtc.r]


def mode_buffers(x: torch.Tensor, qtc: QuantTensorC, mode: str,
                 sms: int) -> tuple:
    """The plan and buffers of a mode launch for x [M, K] over one layer
    of a coalesced q4_0 weight, on x's device: (K1's plan at M on a card of
    `sms` SMs, x as the kernel reads it (f32), y [M, R] f32, the split
    scratch or None)."""
    _check_mode(qtc, mode)
    qm.check_k_tiles(qtc)
    p = qm.plan(qtc, x.shape[0], sms)
    if p.path != "swapped8":
        raise ValueError(f"the modes run on the swapped path at 8 tokens a "
                         f"block (M <= 8), not M = {x.shape[0]}")
    return (p, *qm.operands(x, qtc, p))


def prepare_mode(x: torch.Tensor, qtc: QuantTensorC,
                 mode: str) -> _build.Launch:
    """The mode kernel for x [M, K] over one layer of a coalesced q4_0
    weight on the card (not yet run); its result is y [M, R] f32."""
    _check_mode(qtc, mode)
    dev = x.device
    lo, _, scale, _, tk, tr, n_k, rows, lo_rows, _, sc_rows = qm.weight_args(
        qtc, dev)
    p, xk, y, part = mode_buffers(x, qtc, mode, _sms(dev))
    return _build.Launch(
        _lib().qmatmul_mode_launch,
        (MODES[mode], _build.ptr(xk), xk.shape[1], lo, scale, tk, tr, n_k,
         rows, lo_rows, sc_rows, _build.ptr(y), _build.ptr(part), x.shape[0],
         qtc.kp, qtc.rp, qtc.r, p.mtiles, p.splits, p.tiles_per_split),
        dev, "qmatmul_mode_launch", _count, y, (xk, part, qtc))


def mode_run(x: torch.Tensor, qtc: QuantTensorC, mode: str) -> torch.Tensor:
    """A mode over one layer: its kernel for x on the card, else its plain
    version."""
    if x.is_cuda:
        return prepare_mode(x, qtc, mode)()
    return mode_plain(x, qtc, mode)
