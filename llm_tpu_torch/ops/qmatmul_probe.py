"""Probe variants of the qmatmul kernel, for the chip probes of
`llm_tpu_torch.probes`: the counterparts of the TPU kernels of
`scripts/probe_kernel_decompose.py` (P2), `scripts/probe_coalesced.py`'s
stream-only pass (P1) and `scripts/probe_dequant_variants.py` (P3).

The CUDA is `csrc/qmatmul_probe.cu`, which includes the scalar kernel's
body (`csrc/qmatmul_body.cuh`: one thread a column, f32 FMAs, the
production kernel before the tensor-core one of `csrc/qmatmul_tc.cuh`): a
probe runs that kernel's own loads, grid and K split (`plan` below at the
same M), and `prepare_full` launches it whole (P2's `full`, and the old
side of the A/B against the tensor-core kernel).

Stages, one value a column of the padded width Rp, reading no x (P2's
stream / unpack / dequant, and P1's `<name>_stream`), for q4_0 and q8_0
with f16-packed scales and q6_k, over planes or a coalesced buffer:

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
at most 11264 terms).

Modes, y [M, R] over a coalesced q4_0 buffer with f16-packed scales (the
reference probe's format): base (the scalar kernel's arithmetic), bf16,
f32dot, ghoist, noscale, nounpack (`csrc/qmatmul_body.cuh` Mode; noscale
and nounpack are wrong on purpose). They compute the reference probe's
numbers for its modes of the same names.

Each wrapper runs the plain version for a tensor on the CPU and the kernel
for one on the card, or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ops.packing import (
    FORMAT_IDS,
    QuantTensor,
    QuantTensorC,
    _as_int32_bits,
    coalesced_word_planes,
    dequant,
    scale_plane_f32,
    uncoalesce_qt,
    unpack_q,
)
from llm_tpu_torch.ops.qmatmul import weight_args

STAGES = {"stream": 1, "unpack": 2, "dequant": 3}
MODES = {"base": 0, "bf16": 1, "f32dot": 2, "ghoist": 3, "noscale": 4,
         "nounpack": 5}
# (format, f16-packed scales) the stage kernels are built for
STAGE_FORMATS = {("q4_0", True), ("q8_0", True), ("q6_k", False)}

LAUNCHES = 0  # probe kernel launches (full, stages, modes; plain not)

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "qmatmul_full_launch": [_C, _C, _C, _P, _P, _P, _P, _P, _C, _C, _C, _C,
                            _C, _C, _C, _P, _P, _C, _C, _C, _C, _C, _C, _P],
    "qmatmul_stage_launch": [_C, _C, _C, _P, _P, _P, _P, _C, _C, _C, _C, _C,
                             _C, _C, _P, _P, _C, _C, _C, _C, _C, _P],
    "qmatmul_mode_launch": [_C, _C, _P, _P, _P, _C, _C, _C, _C, _C, _C, _P,
                            _P, _C, _C, _C, _C, _C, _C, _P],
}


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def _lib():
    return _build.load("qmatmul_probe", _SIGNATURES)


# ---------------------------------------------------------------------------
# the scalar kernel's plan and operands

_THREADS = 128  # output columns per block (csrc/qmatmul_body.cuh kThreads)
_UNIT = 32  # K elements per dequant unit (kUnit)
_CHUNK_UNITS = 8  # units of x staged per pass (kChunk / kUnit)


def plan(w, M: int, sms: int = 132) -> tuple[int, int, int]:
    """(rows of x per thread, K splits, 32-element units per split) of the
    scalar kernel on a card of `sms` SMs: split K only when the (column,
    row) blocks alone would leave SMs idle. The blocks are counted over R
    rounded to 128, not the padded width, so a coalesced buffer padded
    wider splits K as its planes do."""
    mt = 1 if M == 1 else 16
    blocks = math.ceil(w.r / _THREADS) * math.ceil(M / mt)
    n_units = w.k_padded // _UNIT
    splits = 1
    if blocks < 2 * sms:
        splits = min(math.ceil(4 * sms / blocks), n_units)
    ups = math.ceil(n_units / splits)
    ups = math.ceil(ups / _CHUNK_UNITS) * _CHUNK_UNITS  # whole x chunks
    return mt, math.ceil(n_units / ups), ups


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def operands(x: torch.Tensor, w, x_dtype=torch.bfloat16) -> tuple:
    """The buffers of a scalar-kernel launch for x [M, K] (M >= 1, any
    float) over one layer of `w`: x zero-padded to Kp in `x_dtype`, the
    output y [M, R] f32, the plan at M (mt, splits, ups) and the split
    scratch [splits, M, Rp] f32 (None when K is not split)."""
    if x.dim() != 2 or x.shape[1] != w.k or x.shape[0] == 0:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} vs weight K={w.k}")
    dev, M = x.device, x.shape[0]
    xp = torch.zeros((M, w.k_padded), dtype=x_dtype, device=dev)
    xp[:, : w.k] = x
    y = torch.empty((M, w.r), dtype=torch.float32, device=dev)
    mt, splits, ups = plan(w, M, _sms(dev))
    part: Optional[torch.Tensor] = (
        torch.empty((splits, M, w.r_padded), dtype=torch.float32, device=dev)
        if splits > 1 else None)
    return xp, y, (mt, splits, ups), part


def prepare_full(x: torch.Tensor, w) -> _build.Launch:
    """The scalar kernel whole for x [M, K] over one layer of `w` (planes
    or a coalesced buffer, any of the 10 formats) on the card (not yet
    run); its result is y [M, R] f32, what `qmatmul.qmatmul` computes."""
    if not isinstance(w, (QuantTensor, QuantTensorC)):
        raise ValueError("prepare_full takes a quantized weight")
    dev = x.device
    args = weight_args(w, dev)
    xp, y, (mt, splits, ups), part = operands(x, w)
    return _build.Launch(
        _lib().qmatmul_full_launch,
        (FORMAT_IDS[w.fmt_name], int(w.scale_packed), mt, _build.ptr(xp),
         *args, _build.ptr(y), _build.ptr(part), x.shape[0], w.k_padded,
         w.r_padded, w.r, splits, ups),
        dev, "qmatmul_full_launch", _count, y, (xp, part, w))


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


def prepare_stage(w, stage: str, M: int) -> _build.Launch:
    """The stage kernel over one layer of `w` on the card, with the grid
    and K split of the scalar kernel at M rows of x (not yet run)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if (w.fmt_name, w.scale_packed) not in STAGE_FORMATS:
        raise ValueError(f"stage kernels take {sorted(STAGE_FORMATS)}, not "
                         f"({w.fmt_name!r}, {w.scale_packed})")
    dev = w.device
    args = weight_args(w, dev)
    Kp, Rp = w.k_padded, w.r_padded
    mt, splits, ups = plan(w, M, _sms(dev))
    mtiles = math.ceil(M / mt)
    dt = torch.float32 if stage == "dequant" else torch.int32
    part = torch.empty((splits, mtiles, Rp), dtype=dt, device=dev)
    out = torch.empty(Rp, dtype=dt, device=dev)
    return _build.Launch(
        _lib().qmatmul_stage_launch,
        (STAGES[stage], FORMAT_IDS[w.fmt_name], int(w.scale_packed), *args,
         _build.ptr(part), _build.ptr(out), mtiles, Kp, Rp, splits, ups),
        dev, "qmatmul_stage_launch", _count, out, (part, w))


def stage_run(w, stage: str, M: int = 8) -> torch.Tensor:
    """A stage over one layer of `w`: its kernel for a weight on the card
    (grid of the scalar kernel at M), else its plain version."""
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


def prepare_mode(x: torch.Tensor, qtc: QuantTensorC,
                 mode: str) -> _build.Launch:
    """The mode kernel for x [M, K] over one layer of a coalesced q4_0
    weight on the card (not yet run); its result is y [M, R] f32."""
    _check_mode(qtc, mode)
    dev = x.device
    lo, _, scale, _, tk, tr, n_k, rows, lo_rows, _, sc_rows = weight_args(
        qtc, dev)
    xp, y, (mt, splits, ups), part = operands(
        x, qtc, torch.float32 if mode == "f32dot" else torch.bfloat16)
    return _build.Launch(
        _lib().qmatmul_mode_launch,
        (MODES[mode], mt, _build.ptr(xp), lo, scale, tk, tr, n_k, rows,
         lo_rows, sc_rows, _build.ptr(y), _build.ptr(part), x.shape[0],
         qtc.kp, qtc.rp, qtc.r, splits, ups),
        dev, "qmatmul_mode_launch", _count, y, (xp, part, qtc))


def mode_run(x: torch.Tensor, qtc: QuantTensorC, mode: str) -> torch.Tensor:
    """A mode over one layer: its kernel for x on the card, else its plain
    version."""
    if x.is_cuda:
        return prepare_mode(x, qtc, mode)()
    return mode_plain(x, qtc, mode)
