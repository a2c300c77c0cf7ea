"""Fused dequantize -> matmul: y = x @ W for quantized or dense weights.

The counterpart of `llm_tpu/ops/qmatmul.py`. A quantized weight, as planes
(`QuantTensor`) or as the coalesced buffer (`QuantTensorC`), on a CUDA
tensor goes through the hand-written kernel `csrc/qmatmul.cu` (the port of
the TPU kernels K1 over planes and K3 over the coalesced buffer, on the
tensor cores: `csrc/qmatmul_tc.cuh`); on a CPU tensor it goes through
`qmatmul_plain`, which is `x @ dequant(W)` in f32 like the reference's XLA
fallback. The kernel rounds x and each dequantized weight to bf16 and
accumulates in f32, as the TPU kernel does, so kernel and plain version
agree to bf16 rounding; over the coalesced buffer it sums the same
products in the same order as over the planes, so K3 on `coalesce_qt(W)`
is bit-equal to K1 on W. There is no fallback: a CUDA tensor that the
kernel does not take raises.

`plan` picks the kernel's consumer path from M: swapped (M <= 32: the
weight tile is the mma's A side, 8 or 16 tokens its B side, x read as f32
where it is f32 already) or wide (x, cast to bf16, the A side of wgmma, 64,
128 or 256 tokens a block by M), and splits K where that shortens the
launch.

`coalesce_tiles` and `coalesce_auto` are the reference's tiling rules,
copied so that the port's coalesced buffers equal the reference's.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ops.packing import (
    FORMAT_IDS,
    QFormat,
    QuantTensor,
    QuantTensorC,
    _round_up,
    coalesce_qt,
    coalesced_seg_rows,
    dequant,
    dequant_c,
    pad_r_qt,
    unpack_scales_qt,
)

LAUNCHES = 0  # kernel launches through qmatmul, either layout
LAUNCHES_COALESCED = 0  # those over a coalesced buffer (K3)
LAUNCHES_SWAPPED = 0  # those on the swapped path (M <= 32, x f32)
LAUNCHES_WIDE = 0  # those on the wide path (M > 32, x bf16)

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "qmatmul_launch": [_C, _C, _C, _P, _C, _P, _P, _P, _P, _C, _C, _C, _C,
                       _C, _C, _C, _P, _P, _C, _C, _C, _C, _C, _C, _C, _C,
                       _P],
}
BN = 128  # weight columns a block (csrc/qmatmul_tc.cuh BN)
BK = 64  # k a pipeline stage (BK)
# tc::Path, and tokens a block (the wide path's by M: `wide_bm`)
PATHS = {"swapped8": 0, "swapped16": 1, "wide": 2}
BM = {"swapped8": 8, "swapped16": 16}
STAGES = {"swapped8": 4, "swapped16": 4}  # the swapped rings' stages
SWAPPED_MAX_M = 32  # above: the wide path
# blocks an SM holds at most, by the kernels' __launch_bounds__ (registers);
# the wide path's by bm
REG_BLOCKS = {"swapped8": 4, "swapped16": 4, "wide": {64: 2, 128: 2, 256: 1}}
SM_SMEM = 228 * 1024  # shared memory of an H100 SM; a block reserves 1 KB
# the wide path (csrc/qmatmul_tc.cuh Wide), by bm: a block takes at most
# 113 KB (bm 64: two an SM) or 227 KB: 1 KB of alignment, a ring of 4 x
# tiles with an mbarrier each, three bf16 weight tiles and a ring of at
# most 16 packed stages
WIDE_SMEM_MAX = {64: 115712, 128: 232448, 256: 232448}
WIDE_X_STAGES = 4
WIDE_B_TILES = 3
WIDE_MAX_PSTAGES = 16
# a block's pipeline fill, in stage times: what a plan charges a block on
# top of its tiles
FILL_TILES = 2

QWeight = (QuantTensor, QuantTensorC)


class Plan(NamedTuple):
    """A launch's tiling: the consumer path, tokens a block (`bm`), blocks
    over the tokens (`mtiles`) and over R rounded to BN (`rblocks`), K
    splits and 64-k tiles a split."""

    path: str
    bm: int
    mtiles: int
    rblocks: int
    splits: int
    tiles_per_split: int


def qmatmul_plain(x: torch.Tensor, w) -> torch.Tensor:
    """x [M, K] @ dequant(w) [K, R] -> [M, R] f32: the plain version of the
    kernel (what the reference's XLA fallback computes)."""
    wd = dequant_c(w) if isinstance(w, QuantTensorC) else dequant(w)
    return x.to(torch.float32) @ wd


def wide_bm(M: int) -> int:
    """Tokens a block of the wide path, in wgmma's 64-row tiles over its
    two warpgroups: 64 (each half the weight columns), 128 (a tile each)
    or 256 (two tiles each)."""
    return 64 if M <= 64 else 128 if M <= 128 else 256


def packed_tile_bytes(fmt: QFormat) -> int:
    """A stage's packed weight rows (csrc/qmatmul_tc.cuh Tile::BYTES) with
    scale rows counted as f32, so that a format's packed and f32
    instantiations plan alike."""
    rows = BK * BN * (fmt.lo_bits + fmt.hi_bits) // 8
    return rows + (BK // fmt.gsize) * BN * 4 * (2 if fmt.has_bias else 1)


def wide_pstages(fmt: QFormat, bm: int) -> int:
    """Stages of the wide path's packed ring (Wide::pstages): what the x
    ring and the weight tiles leave of a block's shared memory."""
    room = (WIDE_SMEM_MAX[bm] - 1024 - WIDE_X_STAGES * (bm * BK * 2 + 8)
            - WIDE_B_TILES * BN * BK * 2)
    return min(WIDE_MAX_PSTAGES, room // packed_tile_bytes(fmt))


def smem_bytes(fmt: QFormat, path: str, bm: Optional[int] = None) -> int:
    """Dynamic shared memory of a block (csrc/qmatmul_tc.cuh Swapped SMEM,
    Wide::smem), counting scale rows as f32: on the swapped paths a ring of
    packed weight tiles and f32 x tiles, the bf16 weight tile and x's bf16
    B fragments; on the wide path (`bm` tokens a block) 1 KB of alignment,
    the x ring with its mbarriers, three bf16 weight tiles and the packed
    ring."""
    if path == "wide":
        return (1024 + WIDE_X_STAGES * (bm * BK * 2 + 8)
                + WIDE_B_TILES * BN * BK * 2
                + wide_pstages(fmt, bm) * packed_tile_bytes(fmt))
    x = BM[path] * (BK + 8) * 4
    return (STAGES[path] * (packed_tile_bytes(fmt) + x) + BN * BK * 2
            + BM[path] * BK * 2)


def blocks_per_sm(fmt: QFormat, path: str, bm: Optional[int] = None) -> int:
    regs = REG_BLOCKS[path][bm] if path == "wide" else REG_BLOCKS[path]
    return min(regs, SM_SMEM // (smem_bytes(fmt, path, bm) + 1024))


def plan(w, M: int, sms: int = 132) -> Plan:
    """The tiling of y = x [M, K] @ w on a card of `sms` SMs. M <= 32 takes
    the swapped path (8 or 16 tokens a block), larger M the wide one (64,
    128 or 256: `wide_bm`).

    K splits: a launch's time is taken as its waves (blocks over what the
    SMs hold at once) times the 64-k tiles a block runs, plus its pipeline
    fill; the plan takes the split of least time (the fewest splits among
    equals). The wide path splits only to fill one wave: its partials are
    large. It depends only on M, the format, K padded and R rounded to BN,
    never on the padded width or the scale packing: a coalesced buffer
    padded wider plans as its planes do and sums the same products in the
    same order (K3 bit-equal to K1)."""
    path = ("swapped8" if M <= 8 else "swapped16" if M <= SWAPPED_MAX_M
            else "wide")
    bm = wide_bm(M) if path == "wide" else BM[path]
    mtiles = math.ceil(M / bm)
    rblocks = math.ceil(w.r / BN)
    n_kt = w.k_padded // BK
    cap = blocks_per_sm(w.fmt, path, bm) * sms
    blocks = rblocks * mtiles
    best = None
    for s in range(1, n_kt + 1):
        tps = math.ceil(n_kt / s)
        splits = math.ceil(n_kt / tps)
        waves = math.ceil(blocks * splits / cap)
        if path == "wide" and splits > 1 and waves > 1:
            break
        cost = waves * (tps + FILL_TILES)
        if best is None or cost < best[0]:
            best = (cost, splits, tps)
    _, splits, tps = best
    return Plan(path, bm, mtiles, rblocks, splits, tps)


def _expect(t, dtype, shape, dev, what: str) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"qmatmul: {what} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def weight_args(w, dev) -> tuple:
    """The kernel's weight arguments for one layer of `w` (planes or a
    coalesced buffer), after checking device, dtype, shape and contiguity:
    lo, hi, scale, bias pointers, then tile_k, tile_r, n_k, rows_tile and
    the lo, hi and scale rows of a k-tile (tile_r 0 for planes). The
    checks are what every kernel over the layouts needs (Rp % 128, Kp and
    tile_k % 32); `prepare` adds its own."""
    fmt = w.fmt
    Kp, Rp = w.k_padded, w.r_padded
    if Rp % BN or Kp % 32:
        raise ValueError(f"qmatmul: padded shape ({Kp}, {Rp}) not supported")
    if fmt.name.endswith("_k") and w.scale_packed:
        raise ValueError("qmatmul: K-quant scales must be f32")
    if isinstance(w, QuantTensorC):
        if w.tile_k % 32 or w.tile_r % BN or Kp % w.tile_k or \
                Rp % w.tile_r:
            raise ValueError(f"qmatmul: coalesced tiles ({w.tile_k}, "
                             f"{w.tile_r}) not supported over ({Kp}, {Rp})")
        segs = w.seg_rows
        rows = sum(segs)
        _expect(w.buf, torch.int32, (Rp // w.tile_r * w.n_k * rows, w.tile_r),
                dev, "the coalesced buffer")
        starts = [sum(segs[:i]) for i in range(4)]
        base = w.buf.data_ptr()
        seg = [_P(base + o * w.tile_r * 4 if n else 0)
               for o, n in zip(starts, segs)]
        return (*seg, w.tile_k, w.tile_r, w.n_k, rows, segs[0], segs[1],
                segs[2])
    g, packed = fmt.gsize, w.scale_packed
    if fmt.lo_bits == 8:
        _expect(w.lo, torch.int8, (Kp, Rp), dev, "the lo plane")
    else:
        _expect(w.lo, torch.int32, (Kp * fmt.lo_bits // 32, Rp), dev,
                "the lo plane")
    if fmt.hi_bits:
        _expect(w.hi, torch.int32, (Kp * fmt.hi_bits // 32, Rp), dev,
                "the hi plane")
    sdt, srows = (torch.int32, Kp // g // 2) if packed else \
        (torch.float32, Kp // g)
    _expect(w.scale, sdt, (srows, Rp), dev, "the scale plane")
    if fmt.has_bias:
        _expect(w.bias, sdt, (srows, Rp), dev, "the bias plane")
    ptr = _build.ptr
    return (ptr(w.lo), ptr(w.hi), ptr(w.scale), ptr(w.bias), 0, 0, 0, 0, 0,
            0, 0)


def _count(coalesced: bool, path: str) -> None:
    global LAUNCHES, LAUNCHES_COALESCED, LAUNCHES_SWAPPED, LAUNCHES_WIDE
    LAUNCHES += 1
    LAUNCHES_COALESCED += coalesced
    LAUNCHES_WIDE += path == "wide"
    LAUNCHES_SWAPPED += path != "wide"


def operands(x: torch.Tensor, w, p: Plan) -> tuple:
    """The buffers of a launch for x [M, K] (M >= 1, any float) over one
    layer of `w` on plan `p`: x as the kernel reads it (f32 on the swapped
    paths, bf16 on the wide one; the kernel takes its columns past its
    width, up to Kp, as zeros), the output y [M, R] f32 and the split
    scratch [splits, M, R rounded to BN] f32 (None when K is not split). x
    is read in place where it is already of that type, contiguous and
    16-byte aligned with rows of whole 16-byte chunks; the wide path casts
    it; any other x is copied, zero-padded to Kp."""
    if x.dim() != 2 or x.shape[1] != w.k or x.shape[0] == 0:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} vs weight K={w.k}")
    dev, M = x.device, x.shape[0]
    dt = torch.bfloat16 if p.path == "wide" else torch.float32
    xk = x.to(dt).contiguous()
    if xk.data_ptr() % 16 or (w.k * xk.element_size()) % 16:
        xk = torch.zeros((M, w.k_padded), dtype=dt, device=dev)
        xk[:, : w.k] = x
    y = torch.empty((M, w.r), dtype=torch.float32, device=dev)
    part = (torch.empty((p.splits, M, p.rblocks * BN), dtype=torch.float32,
                        device=dev) if p.splits > 1 else None)
    return xk, y, part


def check_k_tiles(w) -> None:
    """The kernel's k-tiles of 64 must tile K padded and a coalesced
    buffer's tile_k."""
    if w.k_padded % BK or (isinstance(w, QuantTensorC) and w.tile_k % BK):
        raise ValueError(f"qmatmul: K padded to {w.k_padded} (tile_k "
                         f"{getattr(w, 'tile_k', None)}) is not a multiple "
                         f"of {BK}")


def prepare(x: torch.Tensor, w) -> _build.Launch:
    """Check x [M, K] (M >= 1, any float) and a one-layer weight (planes or
    a coalesced buffer) on one CUDA device, stage x as the kernel reads it,
    allocate the output y [M, R] f32 and the split scratch, and return the
    kernel launch (not yet run). Each call of the result launches the
    kernel and returns y."""
    dev = x.device
    args = weight_args(w, dev)
    check_k_tiles(w)
    M = x.shape[0]
    p = plan(w, M, torch.cuda.get_device_properties(dev).multi_processor_count)
    xk, y, part = operands(x, w, p)
    lib = _build.load("qmatmul", _SIGNATURES)
    coalesced = isinstance(w, QuantTensorC)
    return _build.Launch(
        lib.qmatmul_launch,
        (FORMAT_IDS[w.fmt_name], int(w.scale_packed), PATHS[p.path],
         _build.ptr(xk), xk.shape[1], *args, _build.ptr(y), _build.ptr(part),
         M, w.k_padded, w.r_padded, w.r, p.bm, p.mtiles, p.splits,
         p.tiles_per_split),
        dev, "qmatmul_launch", lambda: _count(coalesced, p.path), y,
        (xk, part, w))


def qmatmul_cuda(x: torch.Tensor, w) -> torch.Tensor:
    """Launch csrc/qmatmul.cu: x [M, K] (any float) @ dequant(w) -> [M, R]
    f32. w is one layer (a view of a stacked weight is fine)."""
    if x.shape[0] == 0:
        return torch.empty((0, w.r), dtype=torch.float32, device=x.device)
    return prepare(x, w)()


def qmatmul(x: torch.Tensor, w, layer=None) -> torch.Tensor:
    """y = x @ W for dense ([K, R] tensor) or quantized (QuantTensor or
    QuantTensorC) W.

    x: [..., K] float; returns [..., R] float32. `layer` selects one layer
    of layer-stacked weights (a view: the kernel reads the layer in place).
    """
    if layer is not None:
        w = w.layer(layer) if isinstance(w, QWeight) else w[layer]
    if isinstance(w, QWeight):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = qmatmul_cuda(x2, w) if x2.is_cuda else qmatmul_plain(x2, w)
        return y.reshape(*lead, w.r)
    if x.is_cuda:
        # the reference's accelerator rule for a dense weight: bf16
        # operands, f32 accumulation and result; the CPU keeps f32
        lead = x.shape[:-1]
        y = _mm_f32_out(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                        w.to(torch.bfloat16))
        return y.reshape(*lead, w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


# whether torch.mm takes out_dtype for these operands here: None until the
# first dense product on the card, then True or False
MM_OUT_DTYPE: Optional[bool] = None


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ bf16 b with an f32 result: `torch.mm(out_dtype=...)` keeps
    the f32 accumulator where the installed torch has it for these
    operands; otherwise the bf16 result is cast up."""
    global MM_OUT_DTYPE
    if MM_OUT_DTYPE is not False:
        try:
            y = torch.mm(a, b, out_dtype=torch.float32)
            MM_OUT_DTYPE = True
            return y
        except (TypeError, NotImplementedError, RuntimeError):
            MM_OUT_DTYPE = False
    return torch.mm(a, b).to(torch.float32)


def quant_rows_lookup(w, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: dequantize the selected logical rows.

    ggml get_rows analog: for a table stored K-major ([K-planes, R=vocab]),
    gather columns `ids` then dequantize. Returns [len(ids), K] float32.
    """
    if isinstance(w, QuantTensor):

        def cols(p):
            return None if p is None else p[:, ids]

        sub = QuantTensor(w.fmt_name, w.k, ids.shape[0], cols(w.lo),
                          cols(w.hi), cols(w.scale), cols(w.bias))
        return dequant(sub).t()
    return w[:, ids].to(torch.float32).t()


# ---------------------------------------------------------------------------
# coalesced tiling (the reference's rules; the TPU's VMEM sub-slicing is
# copied only because coalesce_tiles returns it)


def _pick_tile(n: int, pref: int, step: int) -> int:
    """Largest multiple of `step` that divides n and is <= pref (n itself
    as fallback when n has no such divisor)."""
    t = min(pref, n)
    t = (t // step) * step
    while t >= step:
        if n % t == 0:
            return t
        t -= step
    return n


def _pick_sub_c(segs, tile_k: int, target: int) -> int:
    """Sub-slice count: every non-empty segment's sliced row count a
    multiple of 8, and tile_k divided evenly."""
    if target <= 0 or tile_k <= target:
        return 1
    for n in range(tile_k // target, 1, -1):
        if tile_k % n:
            continue
        if all(s % n == 0 and (s // n) % 8 == 0 for s in segs if s):
            return n
    return 1


def _sub_target_c(tile_r: int) -> int:
    """Default K elements per dequant sub-slice (~2M elements a slice)."""
    return max(512, (2048 * 256) // max(tile_r, 1))


def coalesce_tiles(fmt: QFormat, Kp: int, Rp: int, packed: bool,
                   sub_target: Optional[int] = None) -> tuple[int, int, int]:
    """(tile_k, tile_r, sub_slices) for coalescing a weight: whole K when a
    bounded sub-slicing exists, else the largest legal tile_k <= 2048;
    tile_r <= 512 dividing Rp. Raises ValueError when no tile_k is legal."""
    tile_r = _pick_tile(Rp, 512, 128)
    if sub_target is None:
        sub_target = _sub_target_c(tile_r)

    def legal(tk):
        segs = coalesced_seg_rows(fmt, tk, packed)
        return Kp % tk == 0 and all(s % 8 == 0 for s in segs if s)

    if legal(Kp):
        segs = coalesced_seg_rows(fmt, Kp, packed)
        n = _pick_sub_c(segs, Kp, sub_target)
        if Kp <= max(2048, sub_target) or (
            n > 1 and Kp // n <= max(2048, sub_target)
        ):
            return Kp, tile_r, n
    for tk in range(min(2048, Kp), 63, -64):
        if legal(tk):
            segs = coalesced_seg_rows(fmt, tk, packed)
            return tk, tile_r, _pick_sub_c(segs, tk, sub_target)
    raise ValueError(f"no legal coalesce tile_k for {fmt.name} Kp={Kp}")


def coalesce_auto(qt: QuantTensor, min_k: int = 2048) -> Optional[QuantTensorC]:
    """QuantTensorC for `qt` (flat or stacked) under the reference's
    tiling, or None where the reference keeps planes: Kp below `min_k`, or
    no legal tiling. R is padded to the widest of 512, 256, 128 that wastes
    at most 5% of the bytes; f16-packed scales are tried first, then the
    lossless f32 expansion."""
    if qt.k_padded < min_k:
        return None
    for mult in (512, 256, 128):
        if (_round_up(qt.r_padded, mult) - qt.r_padded) * 20 <= qt.r_padded:
            qt = pad_r_qt(qt, mult)
            break

    def cands():
        yield qt
        if qt.scale_packed:
            yield unpack_scales_qt(qt)

    for cand in cands():
        try:
            tk, tr, _ = coalesce_tiles(cand.fmt, cand.k_padded,
                                       cand.r_padded, cand.scale_packed)
        except ValueError:
            continue
        return coalesce_qt(cand, tk, tr)
    return None
