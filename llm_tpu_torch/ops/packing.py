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

`QuantTensorC` is the reference's coalesced layout of the same planes
(`coalesce_qt`, `uncoalesce_qt`, `dequant_c`), bit-equal to it; the CUDA
kernel reads it as well as planes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from llm_tpu_torch.ggml.types import QK_K, GgmlType, block_size, type_size


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


def unfuse_quant(qt) -> "Optional[list[QuantTensor]]":
    """Invert fuse_quant by slicing the planes at the padded column offsets
    (exact: blocks only span K). A coalesced tensor is first converted back
    to planes. None for a tensor that was not fused."""
    if isinstance(qt, QuantTensorC):
        qt = uncoalesce_qt(qt)
    if qt.splits is None:
        return None
    outs, off = [], 0

    def sl(p, off, rp):
        return None if p is None else p[..., off : off + rp]

    for r, rp in qt.splits:
        outs.append(QuantTensor(qt.fmt_name, qt.k, r, sl(qt.lo, off, rp),
                                sl(qt.hi, off, rp), sl(qt.scale, off, rp),
                                sl(qt.bias, off, rp)))
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


def _k4_scale_min(sb: torch.Tensor):
    """get_scale_min_k4 of the 8 sub-blocks: [..., 12] bytes -> (scale,
    min) int32 [..., 8]."""
    b = sb.to(torch.int32)
    sc = torch.cat([b[..., 0:4] & 63,
                    (b[..., 8:12] & 0xF) | ((b[..., 0:4] >> 6) << 4)], -1)
    mn = torch.cat([b[..., 4:8] & 63,
                    (b[..., 8:12] >> 4) | ((b[..., 4:8] >> 6) << 4)], -1)
    return sc, mn


def _decode_kquant(t: GgmlType, blocks: torch.Tensor):
    """Canonical decoding of the K-quants with torch ops, the twin of
    ggml/quant.py's `_dec_q2_k` ... `_dec_q6_k`: blocks uint8 [..., nb, ts]
    -> (q int32 [..., nb, 256], scale f32 [..., nb, 256/g], bias f32 |
    None). Every scale product is exact in f32 (an f16 times at most 8
    bits), as in the numpy decode."""
    b = blocks.to(torch.int32)
    lead = b.shape[:-1]

    def ar(n, *ones):  # 0..n-1 along the dim that has len(ones) dims after
        return torch.arange(n, dtype=torch.int32, device=b.device).reshape(
            n, *ones)

    def row_major(x):  # [..., nb, a, b, 32] -> [..., nb, 256]
        return x.reshape(*lead, QK_K)

    if t in (GgmlType.Q2_K, GgmlType.Q3_K):
        # element order: half (2) x shift (4) x byte (32)
        qs_off = 16 if t == GgmlType.Q2_K else 32
        qs = b[..., qs_off:qs_off + 64].reshape(*lead, 2, 1, 32)
        shift = ar(4, 1)
        q = (qs >> (2 * shift)) & 3
        if t == GgmlType.Q2_K:
            sc = b[..., 0:16]  # group order == scale byte order
            return (row_major(q), _f16_field(blocks, 80) * (sc & 0xF),
                    -(_f16_field(blocks, 82) * (sc >> 4)))
        hm = b[..., 0:32].reshape(*lead, 1, 1, 32)
        half = ar(2, 1, 1)
        q = q | (((hm >> (half * 4 + shift)) & 1) << 2)
        s = b[..., 96:108]
        sc = torch.cat([
            (s[..., 0:4] & 0xF) | ((s[..., 8:12] & 3) << 4),
            (s[..., 4:8] & 0xF) | (((s[..., 8:12] >> 2) & 3) << 4),
            (s[..., 0:4] >> 4) | (((s[..., 8:12] >> 4) & 3) << 4),
            (s[..., 4:8] >> 4) | (((s[..., 8:12] >> 6) & 3) << 4)], -1)
        return row_major(q), _f16_field(blocks, 108) * (sc - 32), None
    if t in (GgmlType.Q4_K, GgmlType.Q5_K):
        # element order: chunk (4) x {low, high nibble} x byte (32)
        qs_off = 16 if t == GgmlType.Q4_K else 48
        qs = b[..., qs_off:qs_off + 128].reshape(*lead, 4, 1, 32)
        sub = ar(2, 1)
        q = (qs >> (4 * sub)) & 0xF
        if t == GgmlType.Q5_K:  # chunk c, nibble s: qh bit 2c + s
            qh = b[..., 16:48].reshape(*lead, 1, 1, 32)
            chunk = ar(4, 1, 1)
            q = q | (((qh >> (2 * chunk + sub)) & 1) << 4)
        sc, mn = _k4_scale_min(b[..., 4:16])
        return (row_major(q), _f16_field(blocks, 0) * sc,
                -(_f16_field(blocks, 2) * mn))
    if t == GgmlType.Q6_K:
        # element order: half (2) x {q1 .. q4} x byte (32); q1/q3 the low
        # and high nibbles of ql's first 32 bytes of the half, q2/q4 of its
        # second 32, the two high bits from qh at 0, 2, 4, 6
        ql = b[..., 0:128].reshape(*lead, 2, 1, 2, 32)  # [.., half, 1, r&1]
        qh = b[..., 128:192].reshape(*lead, 2, 1, 1, 32)
        hi_nib = ar(2, 1, 1)
        lo4 = (ql >> (4 * hi_nib)) & 0xF  # [..., half, r>>1, r&1, 32]
        r = 2 * hi_nib + ar(2, 1)
        q = lo4 | (((qh >> (2 * r)) & 3) << 4)
        sc = blocks[..., 192:208].contiguous().view(torch.int8).to(
            torch.int32)  # group order == scale byte order
        return row_major(q), _f16_field(blocks, 208) * sc, None
    raise NotImplementedError(t)


_SCALAR = (GgmlType.Q4_0, GgmlType.Q4_1, GgmlType.Q5_0, GgmlType.Q5_1,
           GgmlType.Q8_0)


def raw_bytes(t: GgmlType, data, K: int, R: int) -> torch.Tensor:
    """The block bytes of an R x K tensor of type `t` as a host uint8
    tensor (a copy: reading a memory-mapped file happens here)."""
    n_bytes = K * R // block_size(t) * type_size(t)
    return torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8, count=n_bytes).copy())


def decode_plain(t: GgmlType, raw: torch.Tensor, K: int, R: int):
    """The plain version of `native.decode`, with torch ops on the device
    of `raw` (uint8 block bytes): (q int32 [R, K], scale f32 [R, K/g],
    bias f32 [R, K/g] | None), bit-equal to ggml/quant.decode_blocks."""
    blocks = raw.reshape(R, K // block_size(t), type_size(t))
    dec = _decode_scalar if t in _SCALAR else _decode_kquant
    q, s, b = dec(t, blocks)
    return (q.reshape(R, K), s.reshape(R, -1),
            b.reshape(R, -1) if b is not None else None)


def decode_ggml(t: GgmlType, data, K: int, R: int, device):
    """(q int32 [R, K], scale f32 [R, K/g], bias f32 [R, K/g] | None) on
    `device`: the raw block bytes are copied there and decoded, on a CUDA
    device by the codec kernel (`native.decode`), on the CPU by
    `decode_plain`."""
    from llm_tpu_torch import native  # (native imports this module)

    raw = raw_bytes(t, data, K, R).to(device)
    if raw.is_cuda:
        return native.decode(t, raw, K, R)
    return decode_plain(t, raw, K, R)


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

    return pack_decoded(t, K, decode_ggml(t, data, K, R, device), rows=rows,
                        r_multiple=r_multiple, k_multiple=k_multiple)


def pack_decoded(
    t: GgmlType,
    K: int,
    decoded: tuple,
    *,
    rows: Optional[np.ndarray] = None,
    r_multiple: int = 128,
    k_multiple: int = 0,
) -> QuantTensor:
    """The planes `pack_ggml` builds, from a quantized tensor that
    `decode_ggml` has already decoded ((q [R, K], scale, bias) on their
    device): a fused tensor is decoded once for all of its row
    selections."""
    fmt = FORMATS[t]
    g = fmt.gsize
    q, scale, bias = decoded
    device = q.device
    R = q.shape[0]
    if rows is not None:
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.long,
                              device=device)
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
# coalesced layout: every plane of one (r-tile, k-tile) block in one span
#
#     buf int32 [(L,) n_r * n_k * rows_tile, tile_r]   rows_tile = lo|hi|scale|bias
#
# For each output tile r and reduction tile k, the block's lo rows, then hi
# rows, then scale rows, then bias rows sit consecutively, bit-equal to the
# reference's `coalesce_qt`. f32 scale planes are kept as their bits; q8_0's
# int8 plane is byte-packed four to a word (two's complement).


def coalesced_seg_rows(fmt: QFormat, tile_k: int,
                       scale_packed: bool) -> tuple[int, int, int, int]:
    """Word rows of each segment (lo, hi, scale, bias) per k-tile."""
    lo = tile_k // (32 // fmt.lo_bits) if fmt.lo_bits < 8 else tile_k // 4
    hi = tile_k // (32 // fmt.hi_bits) if fmt.hi_bits else 0
    sc = tile_k // fmt.gsize // (2 if scale_packed else 1)
    return lo, hi, sc, (sc if fmt.has_bias else 0)


def _bytes_pack(a: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, R] -> int32 words [..., K/4, R], element e of each word
    in bits [8e, 8e+8) as a two's-complement byte."""
    b = a.to(torch.int64) & 0xFF
    K, R = b.shape[-2], b.shape[-1]
    b = b.reshape(*b.shape[:-2], K // 4, 4, R)
    w = b[..., 0, :] | (b[..., 1, :] << 8) | (b[..., 2, :] << 16) | (
        b[..., 3, :] << 24)
    return _as_int32_bits(w)


@dataclass
class QuantTensorC:
    """A block-quantized matrix in the coalesced layout (see above).

    `buf` is int32 [(L,) n_r*n_k*rows_tile, tile_r]; kp/rp are the padded
    dims the tiling was built over. `layer(l)` is a view of one layer."""

    fmt_name: str
    k: int
    r: int
    kp: int
    rp: int
    tile_k: int
    tile_r: int
    scale_packed: bool
    buf: torch.Tensor
    splits: Optional[tuple] = None

    @property
    def fmt(self) -> QFormat:
        return _BY_NAME[self.fmt_name][1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.k, self.r)

    @property
    def k_padded(self) -> int:
        return self.kp

    @property
    def r_padded(self) -> int:
        return self.rp

    @property
    def n_k(self) -> int:
        return self.kp // self.tile_k

    @property
    def seg_rows(self) -> tuple[int, int, int, int]:
        return coalesced_seg_rows(self.fmt, self.tile_k, self.scale_packed)

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def layer(self, l: int) -> "QuantTensorC":
        """One layer of a stacked buffer: a view, no copy."""
        return dataclasses.replace(self, buf=self.buf[l])


def unpack_scales_qt(qt: QuantTensor) -> QuantTensor:
    """Copy of `qt` with f16-packed scale/bias planes expanded to f32
    (lossless): the layout coalescing falls back to where packed-scale
    segments cannot hold whole 8-row groups (e.g. K=768)."""
    if not qt.scale_packed:
        return qt

    def ex(p):
        return None if p is None else expand_f16x2(p).contiguous()

    return QuantTensor(qt.fmt_name, qt.k, qt.r, qt.lo, qt.hi, ex(qt.scale),
                       ex(qt.bias), qt.splits)


def pad_r_qt(qt: QuantTensor, mult: int) -> QuantTensor:
    """Pad every plane's R axis with zeros up to a multiple of `mult`
    (padded scales are 0, so padded columns dequantize to 0)."""
    Rp = qt.r_padded
    new = _round_up(Rp, mult)
    if new == Rp:
        return qt

    def pad(p):
        if p is None:
            return None
        out = torch.zeros((*p.shape[:-1], new), dtype=p.dtype, device=p.device)
        out[..., :Rp] = p
        return out

    return QuantTensor(qt.fmt_name, qt.k, qt.r, pad(qt.lo), pad(qt.hi),
                       pad(qt.scale), pad(qt.bias), qt.splits)


def coalesce_qt(qt: QuantTensor, tile_k: int, tile_r: int) -> QuantTensorC:
    """Re-tile a QuantTensor's planes (flat or stacked [L, ...]) into the
    coalesced buffer, on the planes' device."""
    fmt = qt.fmt
    packed = qt.scale_packed
    Kp, Rp = qt.k_padded, qt.r_padded
    if Kp % tile_k or Rp % tile_r:
        raise ValueError(f"tiles ({tile_k}, {tile_r}) do not divide "
                         f"({Kp}, {Rp})")
    n_k, n_r = Kp // tile_k, Rp // tile_r
    segs = coalesced_seg_rows(fmt, tile_k, packed)
    if any(s % 8 for s in segs if s):
        raise ValueError(f"coalesce tile_k={tile_k} gives segment rows "
                         f"{segs} for {fmt.name}: not whole 8-row groups")

    def words(p, kind):
        if kind == "lo" and fmt.lo_bits == 8:
            return _bytes_pack(p)
        return p.view(torch.int32) if p.dtype == torch.float32 else p

    def arrange(p, seg):
        # [..., n_k*seg, n_r*tile_r] -> [..., n_r, n_k, seg, tile_r]
        p = p.reshape(*p.shape[:-2], n_k, seg, n_r, tile_r)
        return p.movedim(-2, -4)

    parts = [arrange(words(plane, kind), seg) for plane, kind, seg in (
        (qt.lo, "lo", segs[0]), (qt.hi, "hi", segs[1]),
        (qt.scale, "scale", segs[2]), (qt.bias, "bias", segs[3])) if seg]
    buf = torch.cat(parts, dim=-2)
    buf = buf.reshape(*buf.shape[:-4], n_r * n_k * sum(segs), tile_r)
    return QuantTensorC(fmt.name, qt.k, qt.r, Kp, Rp, tile_k, tile_r, packed,
                        buf.contiguous(), qt.splits)


def coalesced_word_planes(qtc: QuantTensorC) -> list:
    """The buffer's segments back in the plane arrangement, as the int32
    words the buffer holds (lo, hi, scale, bias; None for an absent
    segment): q8_0's lo stays byte-packed, f32 scales stay bits."""
    n_k, n_r = qtc.kp // qtc.tile_k, qtc.rp // qtc.tile_r
    segs = qtc.seg_rows
    b = qtc.buf
    lead = b.shape[:-2]
    b = b.reshape(*lead, n_r, n_k, sum(segs), qtc.tile_r).movedim(-4, -2)
    out, off = [], 0  # b: [..., n_k, rows_tile, n_r, tile_r]
    for seg in segs:
        if not seg:
            out.append(None)
            continue
        out.append(b[..., off : off + seg, :, :].reshape(
            *lead, n_k * seg, n_r * qtc.tile_r))
        off += seg
    return out


def uncoalesce_qt(qtc: QuantTensorC) -> QuantTensor:
    """Exact inverse of coalesce_qt, back to the plane layout."""
    lo, hi, sc, bias = coalesced_word_planes(qtc)
    if qtc.fmt.lo_bits == 8:
        lo = unpack_plane(lo, 8, signed=True).to(torch.int8)
    if not qtc.scale_packed:
        sc = sc.view(torch.float32)
        bias = None if bias is None else bias.view(torch.float32)
    return QuantTensor(qtc.fmt_name, qtc.k, qtc.r, lo, hi, sc, bias,
                       qtc.splits)


def dequant_c(qtc: QuantTensorC, trim: bool = True) -> torch.Tensor:
    """Plain dequantization of the coalesced layout: f32 [..., K, R],
    bit-equal to the reference's `dequant_c_jnp` (the same integer and
    f16->f32 steps on the same words)."""
    return dequant(uncoalesce_qt(qtc), trim)


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
