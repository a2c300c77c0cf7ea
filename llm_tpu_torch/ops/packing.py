"""Packed representation of block-quantized weights, as torch tensors.

The counterpart of `llm_tpu/ops/packing.py`, with exactly its plane rules so
that a plane packed here is bit-equal to the reference's. Every GGML quant
format canonicalizes (ggml/quant.py:decode_blocks) to

    value[k, r] = (q[k, r] - zero) * scale[k // g, r] + bias[k // g, r]

and a quantized matrix is at most four planes, all **K-major** (reduction
dim first, output dim last):

    lo     int32 [(L,) Kp/pw_lo, Rp]  pw = 32 // lo_bits  (int8 [(L,) Kp, Rp] for q8_0)
    hi     int32 [(L,) Kp/pw_hi, Rp]  optional extra high bits (5/3/6-bit formats)
    scale  f32   [(L,) Kp/g, Rp]      or int32 [(L,) Kp/2g, Rp]: two f16 per word
    bias   same as scale              optional (formats with per-group mins)

The word planes hold the reference's uint32 bit patterns in int32 tensors
(torch has no general uint32 arithmetic); `.numpy().view(np.uint32)` gives
the reference's array back. Rp is R padded to 128; Kp is K padded to the
format's K granule; padded scales are 0, so padding contributes nothing.
q4_0's lo plane stores `q - 8` as a two's-complement nibble (`q XOR 8`).

`pack_ggml` builds the planes with torch ops from the raw block bytes, on
whatever device it is given: on the card the repack of a 7B checkpoint runs
there instead of in host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from llm_tpu_torch.ggml.quant import decode_blocks
from llm_tpu_torch.ggml.types import GgmlType, block_size, type_size


@dataclass(frozen=True)
class QFormat:
    """Static descriptor of a canonical quant layout."""

    name: str
    lo_bits: int  # 2, 4 or 8
    hi_bits: int  # 0, 1 or 2
    zero: int
    gsize: int  # elements per scale group
    has_bias: bool
    # lo plane stores (q - zero) as a two's-complement field; only formats
    # whose value is a single field (no hi plane) qualify
    signed_lo: bool = False

    @property
    def bits(self) -> int:
        return self.lo_bits + self.hi_bits


FORMATS: dict[GgmlType, QFormat] = {
    GgmlType.Q4_0: QFormat("q4_0", 4, 0, 8, 32, False, signed_lo=True),
    GgmlType.Q4_1: QFormat("q4_1", 4, 0, 0, 32, True),
    GgmlType.Q5_0: QFormat("q5_0", 4, 1, 16, 32, False),
    GgmlType.Q5_1: QFormat("q5_1", 4, 1, 0, 32, True),
    GgmlType.Q8_0: QFormat("q8_0", 8, 0, 0, 32, False),
    GgmlType.Q2_K: QFormat("q2_k", 2, 0, 0, 16, True),
    GgmlType.Q3_K: QFormat("q3_k", 2, 1, 4, 16, False),
    GgmlType.Q4_K: QFormat("q4_k", 4, 0, 0, 32, True),
    GgmlType.Q5_K: QFormat("q5_k", 4, 1, 0, 32, True),
    GgmlType.Q6_K: QFormat("q6_k", 4, 2, 32, 16, False),
}

_BY_NAME = {f.name: (t, f) for t, f in FORMATS.items()}
# position of each format in FORMATS: the format id the CUDA kernel takes
FORMAT_IDS = {f.name: i for i, f in enumerate(FORMATS.values())}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class QuantTensor:
    """A block-quantized matrix, logical shape (in_features, out_features).

    Planes may carry a leading layer axis L (layer-stacked weights);
    `layer(l)` is then a view of one layer's planes.
    """

    fmt_name: str
    k: int  # logical in_features
    r: int  # logical out_features
    lo: torch.Tensor
    hi: Optional[torch.Tensor]
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    # set by fuse_quant: ((r_i, r_padded_i), ...) per fused member; output
    # columns of member i live at [sum of r_padded_<i>, +r_i)
    splits: Optional[tuple] = None

    @property
    def fmt(self) -> QFormat:
        return _BY_NAME[self.fmt_name][1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.k, self.r)

    @property
    def scale_packed(self) -> bool:
        """Scale plane holds two f16 scales per int32 word (lossless: the
        32-block formats store f16 scales on disk)."""
        return self.scale.dtype == torch.int32

    @property
    def k_padded(self) -> int:
        g = self.fmt.gsize
        return self.scale.shape[-2] * g * (2 if self.scale_packed else 1)

    @property
    def r_padded(self) -> int:
        return self.scale.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def planes(self) -> tuple:
        return (self.lo, self.hi, self.scale, self.bias)

    def layer(self, l: int) -> "QuantTensor":
        """One layer of layer-stacked planes: views, no copy."""

        def sl(p):
            return None if p is None else p[l]

        return QuantTensor(self.fmt_name, self.k, self.r, sl(self.lo),
                           sl(self.hi), sl(self.scale), sl(self.bias),
                           self.splits)


def fuse_quant(qts: "list[QuantTensor]") -> Optional[QuantTensor]:
    """Concatenate same-format QuantTensors along the output (R) axis so one
    kernel launch computes all of them (one q|k|v launch per layer instead
    of three). Works on stacked ([L, ...]) and unstacked planes alike.

    Returns None when the tensors cannot fuse (mixed formats, mismatched K,
    different plane dtypes/presence). Member i's output columns sit at
    [sum(r_padded_<i>), +r_i); see `split_fused`.
    """
    if not all(isinstance(q, QuantTensor) for q in qts) or len(qts) < 2:
        return None
    q0 = qts[0]
    for q in qts[1:]:
        if (
            q.fmt_name != q0.fmt_name
            or q.k != q0.k
            or q.k_padded != q0.k_padded
            or q.scale.dtype != q0.scale.dtype
            or (q.hi is None) != (q0.hi is None)
            or (q.bias is None) != (q0.bias is None)
            or q.lo.shape[:-1] != q0.lo.shape[:-1]
        ):
            return None

    def cat(name):
        planes = [getattr(q, name) for q in qts]
        if planes[0] is None:
            return None
        return torch.cat(planes, dim=-1)

    splits = tuple((q.r, q.r_padded) for q in qts)
    r = sum(rp for _, rp in splits[:-1]) + splits[-1][0]
    return QuantTensor(
        q0.fmt_name, q0.k, r, cat("lo"), cat("hi"), cat("scale"),
        cat("bias"), splits,
    )


def split_fused(y: torch.Tensor, splits: tuple) -> "list[torch.Tensor]":
    """Slice a fused qmatmul output [..., r_fused] back into the member
    outputs ([..., r_i] each), skipping intra-fusion R padding."""
    outs, off = [], 0
    for r, rp in splits:
        outs.append(y[..., off : off + r])
        off += rp
    return outs


# ---------------------------------------------------------------------------
# packing (raw GGML block bytes -> planes)


def _as_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _pack_bits(q: torch.Tensor, bits: int) -> torch.Tensor:
    """[K, R] small non-negative ints -> int32 words [K/(32//bits), R],
    element e of each word at bit (e % pw) * bits."""
    pw = 32 // bits
    k, r = q.shape
    assert k % pw == 0
    f = q.to(torch.int64).reshape(k // pw, pw, r)
    w = torch.zeros((k // pw, r), dtype=torch.int64, device=q.device)
    for i in range(pw):
        w |= f[:, i, :] << (i * bits)
    return _as_int32_bits(w)


def _pack_f16x2(a: torch.Tensor) -> torch.Tensor:
    """f32 [Kg, R] (values exact in f16) -> int32 [Kg/2, R]: group 2w in the
    low 16 bits of word w, group 2w+1 in the high 16."""
    assert a.shape[0] % 2 == 0
    bits = a.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return _as_int32_bits(bits[0::2] | (bits[1::2] << 16))


def _f16_field(blocks: torch.Tensor, off: int) -> torch.Tensor:
    """f16 at byte offset `off` of each block [..., ts] -> f32 [..., 1]."""
    return blocks[..., off : off + 2].contiguous().view(torch.float16).float()


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """[..., 16] bytes -> [..., 32] nibble values, low nibbles first."""
    return torch.cat([qs & 0x0F, qs >> 4], dim=-1).to(torch.int32)


def _q5_high_bits(qh: torch.Tensor) -> torch.Tensor:
    """[..., 4] bytes of the u32 qh -> [..., 32] fifth-bit values (0/16):
    bit j of qh is the high bit of element j."""
    b = qh.to(torch.int64)
    word = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    shifts = torch.arange(32, device=qh.device)
    return (((word[..., None] >> shifts) & 1) << 4).to(torch.int32)


def _decode_scalar(t: GgmlType, blocks: torch.Tensor):
    """Canonical decoding of the 32-block formats with torch ops, the twin
    of ggml/quant.py's `_dec_q*` functions: blocks uint8 [R, nb, ts] ->
    (q int32 [R, nb, 32], scale f32 [R, nb, 1], bias f32 | None)."""
    if t == GgmlType.Q4_0:
        return _nibbles(blocks[..., 2:18]), _f16_field(blocks, 0), None
    if t == GgmlType.Q4_1:
        return (_nibbles(blocks[..., 4:20]), _f16_field(blocks, 0),
                _f16_field(blocks, 2))
    if t == GgmlType.Q5_0:
        q = _nibbles(blocks[..., 6:22]) | _q5_high_bits(blocks[..., 2:6])
        return q, _f16_field(blocks, 0), None
    if t == GgmlType.Q5_1:
        q = _nibbles(blocks[..., 8:24]) | _q5_high_bits(blocks[..., 4:8])
        return q, _f16_field(blocks, 0), _f16_field(blocks, 2)
    if t == GgmlType.Q8_0:
        q = blocks[..., 2:34].contiguous().view(torch.int8).to(torch.int32)
        return q, _f16_field(blocks, 0), None
    raise NotImplementedError(t)


_SCALAR = (GgmlType.Q4_0, GgmlType.Q4_1, GgmlType.Q5_0, GgmlType.Q5_1,
           GgmlType.Q8_0)


def _decode(t: GgmlType, data, K: int, R: int, device):
    """(q int32 [R, K], scale f32 [R, K/g], bias f32 [R, K/g] | None) on
    `device`. The 32-block formats decode there with torch ops; K-quants
    decode on the host (ggml/quant.py) and are then moved."""
    if t in _SCALAR:
        n_bytes = K * R // block_size(t) * type_size(t)
        raw = torch.from_numpy(
            np.frombuffer(data, dtype=np.uint8, count=n_bytes).copy()
        )
        blocks = raw.to(device).reshape(R, K // block_size(t), type_size(t))
        q, s, b = _decode_scalar(t, blocks)
        return (q.reshape(R, K), s.reshape(R, -1),
                b.reshape(R, -1) if b is not None else None)
    dec = decode_blocks(t, data, K * R)
    g = dec.gsize
    q = torch.from_numpy(dec.q.reshape(R, K)).to(device)
    s = torch.from_numpy(np.ascontiguousarray(
        dec.scale.reshape(R, K // g), np.float32)).to(device)
    b = (torch.from_numpy(np.ascontiguousarray(
        dec.bias.reshape(R, K // g), np.float32)).to(device)
        if dec.bias is not None else None)
    return q, s, b


def k_granule(fmt: QFormat, K: int) -> int:
    """Granule Kp is padded to (the reference's rule, kept so that planes
    stay bit-equal to it): every plane's rows must hold whole words, f16
    scale rows must pair up, and above K=16g the reference's TPU tiling
    wants whole 16g tiles."""
    gran = max(fmt.gsize, 32 // fmt.lo_bits if fmt.lo_bits < 8 else 1)
    if _scales_packed(fmt):
        gran = max(gran, 2 * fmt.gsize)
        if K > 8 * 2 * fmt.gsize:
            gran = max(gran, 16 * fmt.gsize)
    return gran


def _scales_packed(fmt: QFormat) -> bool:
    # the 32-block formats carry f16 scales/mins on disk, so two-per-word
    # packing is lossless; K-quants keep f32 (their d*int6 products need
    # the range)
    return not fmt.name.endswith("_k")


def pack_ggml(
    t: GgmlType,
    data: "bytes | np.ndarray",
    dims: tuple,
    *,
    rows: Optional[np.ndarray] = None,
    r_multiple: int = 128,
    k_multiple: int = 0,
    device=None,
) -> "QuantTensor | torch.Tensor":
    """Transcode raw GGML tensor bytes into planes on `device`.

    `dims` is in ggml order: dims[0] = K (row length, quantized axis),
    dims[1] = R (number of rows). Dense (F16/F32) tensors return a plain
    [K, R] tensor in their storage dtype.

    `rows` optionally selects a subset/permutation of the R logical rows
    before packing (quant blocks span K only, so row selection never
    crosses a block boundary).
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    K = dims[0]
    R = dims[1] if len(dims) > 1 else 1
    idx = (torch.as_tensor(np.asarray(rows), dtype=torch.long, device=device)
           if rows is not None else None)

    if t in (GgmlType.F32, GgmlType.F16):
        dt = np.float32 if t == GgmlType.F32 else np.float16
        w = torch.from_numpy(
            np.frombuffer(data, dtype=dt, count=K * R).reshape(R, K).copy()
        ).to(device)
        if idx is not None:
            w = w[idx]
        return w.t().contiguous()

    fmt = FORMATS[t]
    g = fmt.gsize
    q, scale, bias = _decode(t, data, K, R, device)
    if idx is not None:
        q, scale = q[idx], scale[idx]
        if bias is not None:
            bias = bias[idx]
        R = len(rows)

    Rp = _round_up(R, r_multiple) if r_multiple else R
    Kp = _round_up(K, k_multiple) if k_multiple else K
    Kp = _round_up(Kp, k_granule(fmt, K))

    def kmajor(a, k_rows):
        # [R, k] -> K-major [Kp-rows, Rp], zero padded
        out = torch.zeros((k_rows, Rp), dtype=a.dtype, device=device)
        out[: a.shape[1], :R] = a.t()
        return out

    q = kmajor(q, Kp)
    scale = kmajor(scale, Kp // g)
    bias = kmajor(bias, Kp // g) if bias is not None else None

    if fmt.lo_bits == 8:
        lo, hi = q.to(torch.int8), None
    else:
        lo_vals = q & ((1 << fmt.lo_bits) - 1)
        if fmt.signed_lo:
            lo_vals = lo_vals ^ fmt.zero  # store q - zero, two's complement
        lo = _pack_bits(lo_vals, fmt.lo_bits)
        hi = _pack_bits(q >> fmt.lo_bits, fmt.hi_bits) if fmt.hi_bits else None

    if _scales_packed(fmt):
        scale = _pack_f16x2(scale)
        bias = _pack_f16x2(bias) if bias is not None else None
    return QuantTensor(fmt.name, K, R, lo, hi, scale, bias)


# ---------------------------------------------------------------------------
# plain unpack / dequant (the arithmetic the CUDA kernel repeats)


def unpack_plane(words: torch.Tensor, bits: int,
                 signed: bool = False) -> torch.Tensor:
    """int32 words [..., Kw, R] -> int32 fields [..., Kw * (32//bits), R].

    `signed`: fields are two's-complement and come out sign-extended."""
    pw = 32 // bits
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = (torch.arange(pw, device=words.device) * bits)[:, None]
    f = (w.unsqueeze(-2) >> shifts) & ((1 << bits) - 1)  # [..., Kw, pw, R]
    if signed:
        f = f - ((f >> (bits - 1)) << bits)
    *lead, kw, _, r = f.shape
    return f.reshape(*lead, kw * pw, r).to(torch.int32)


def expand_f16x2(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., Kw, R] of packed f16 pairs -> f32 [..., 2*Kw, R] (exact)."""
    h = unpack_plane(words, 16)
    h = h - ((h >> 15) << 16)  # u16 bit pattern -> the int16 with those bits
    return h.to(torch.int16).view(torch.float16).to(torch.float32)


def unpack_q(fmt: QFormat, lo: torch.Tensor,
             hi: Optional[torch.Tensor]) -> torch.Tensor:
    """Integer q [..., K, R] (int32). signed_lo formats come out already
    centered (use effective_zero downstream)."""
    if fmt.lo_bits == 8:
        return lo.to(torch.int32)
    q = unpack_plane(lo, fmt.lo_bits, signed=fmt.signed_lo)
    if fmt.hi_bits:
        q = q | (unpack_plane(hi, fmt.hi_bits) << fmt.lo_bits)
    return q


def effective_zero(fmt: QFormat) -> int:
    """The zero point still to subtract after unpack_q (0 for signed_lo)."""
    return 0 if fmt.signed_lo else fmt.zero


def scale_plane_f32(plane: torch.Tensor) -> torch.Tensor:
    """Scale/bias plane -> f32 rows (expanding packed-f16 planes)."""
    if plane.dtype == torch.int32:
        return expand_f16x2(plane)
    return plane.to(torch.float32)


def dequant(qt: QuantTensor, trim: bool = True) -> torch.Tensor:
    """Plain dequantization: QuantTensor -> f32 [..., K, R], bit-equal to
    the reference's `dequant_jnp`."""
    fmt = qt.fmt
    q = unpack_q(fmt, qt.lo, qt.hi)
    zero = effective_zero(fmt)
    g = fmt.gsize
    w = (q - zero if zero else q).to(torch.float32) * torch.repeat_interleave(
        scale_plane_f32(qt.scale), g, dim=-2
    )
    if qt.bias is not None:
        w = w + torch.repeat_interleave(scale_plane_f32(qt.bias), g, dim=-2)
    if trim:
        w = w[..., : qt.k, : qt.r]
    return w


# ---------------------------------------------------------------------------
# int4 KV rows (paged pools)


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7] [..., D] -> planar-packed uint8 [..., D//2].

    Byte j holds element j in its low nibble and element j + D/2 in its
    high nibble (planar, not interleaved), bit-equal to the reference's
    `pack_int4_rows`. One position's row stays D//2 contiguous bytes, so a
    row write never touches a byte of another position."""
    D = q.shape[-1]
    lo = q[..., : D // 2].to(torch.int32) & 0xF
    hi = (q[..., D // 2 :].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8)


def unpack_int4_rows(b: torch.Tensor) -> torch.Tensor:
    """planar-packed uint8 [..., D//2] -> f32 codes [..., D] in [-8, 7]:
    each nibble sign-extended, the low halves first."""
    x = b.to(torch.int32)
    lo = x & 0xF
    hi = (x >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1).to(torch.float32)
