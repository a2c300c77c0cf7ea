"""Block-quantization codecs for the GGML interchange formats (numpy, host-side).

These are the ground-truth encoders/decoders for every quantized element type
the reference supports. They are deliberately *vectorized numpy* — they run at
load/save time on the host; the TPU compute path never touches these byte
layouts (weights are transcoded once into packed device planes, see
llm_tpu/ops/packing.py).

Every format decodes to a single canonical integer form:

    value[e] = (q[e] - zero) * scale[e // gsize] + bias[e // gsize]

where q is an unsigned (or, for Q8_0, signed) integer of small bit-width and
scale/bias are per-group floats (K-quant two-level scales are flattened into
per-group effective scales at decode time). Float dequantization and the
packed on-device layout are both derived from this one decoding.

Layouts follow the ggml C structs captured in the reference's bindgen output
(llm/crates/ggml/sys/src/lib.rs:2779-3516):

* Q4_0: {f16 d;  u8 qs[16]}                      x = (q4 - 8) * d
* Q4_1: {f16 d; f16 m; u8 qs[16]}                x = q4 * d + m
* Q5_0: {f16 d; u32 qh; u8 qs[16]}               x = (q5 - 16) * d
* Q5_1: {f16 d; f16 m; u32 qh; u8 qs[16]}        x = q5 * d + m
* Q8_0: {f16 d; i8 qs[32]}                       x = q * d
* Q2_K: {u8 scales[16]; u8 qs[64]; f16 d,dmin}   x = d*sc*q2 - dmin*mn
* Q3_K: {u8 hmask[32]; u8 qs[64]; u8 scales[12]; f16 d}
* Q4_K: {f16 d,dmin; u8 scales[12]; u8 qs[128]}
* Q5_K: {f16 d,dmin; u8 scales[12]; u8 qh[32]; u8 qs[128]}
* Q6_K: {u8 ql[128]; u8 qh[64]; i8 scales[16]; f16 d}

The nibble split within a 32-block is low-nibbles = elements 0..15,
high-nibbles = elements 16..31 (ggml dequantize_row_* convention).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from llm_tpu_torch.ggml.types import GgmlType, QK_K, block_size, type_size

# ---------------------------------------------------------------------------
# helpers


def _f16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32)


def _scale_f16(b: np.ndarray, lo: int) -> np.ndarray:
    """Read a f16 field at byte offset lo of each block -> f32 [nb, 1]."""
    return _f16(b[:, lo : lo + 2].copy().view("<f2"))


def _as_blocks(data: bytes | np.ndarray, t: GgmlType, n_elements: int) -> np.ndarray:
    """View raw bytes as [n_blocks, type_size] uint8."""
    bs, ts = block_size(t), type_size(t)
    if n_elements % bs != 0:
        raise ValueError(f"{n_elements} not a multiple of block size {bs} for {t}")
    nb = n_elements // bs
    buf = np.frombuffer(data, dtype=np.uint8, count=nb * ts)
    return buf.reshape(nb, ts)


def _nibbles(qs: np.ndarray) -> np.ndarray:
    """[..., 16] bytes -> [..., 32] nibble values in ggml order (low then high)."""
    lo = qs & 0x0F
    hi = qs >> 4
    return np.concatenate([lo, hi], axis=-1)


def _pack_nibbles(vals: np.ndarray) -> np.ndarray:
    """[..., 32] nibble values -> [..., 16] bytes, ggml order."""
    lo = vals[..., :16]
    hi = vals[..., 16:]
    return (lo | (hi << 4)).astype(np.uint8)


# ---------------------------------------------------------------------------
# canonical integer decoding


@dataclass
class Decoded:
    """Canonical integer decoding of a run of blocks.

    value[i, e] = (q[i, e] - zero) * scale[i, e // gsize] + bias[i, e // gsize]
    """

    q: np.ndarray  # int32 [nb, block]
    scale: np.ndarray  # f32 [nb, block // gsize]
    bias: np.ndarray | None  # f32 [nb, block // gsize] (additive, already signed)
    zero: int
    gsize: int
    bits: int  # significant bits in q (8 for Q8_0, signed)

    def to_float(self) -> np.ndarray:
        nb, blk = self.q.shape
        g = self.gsize
        s = np.repeat(self.scale, g, axis=1)
        y = (self.q - self.zero) * s
        if self.bias is not None:
            y = y + np.repeat(self.bias, g, axis=1)
        return y.astype(np.float32)


def decode_blocks(t: GgmlType, data: bytes | np.ndarray, n_elements: int) -> Decoded:
    fn = _DECODE.get(t)
    if fn is None:
        raise NotImplementedError(f"decode for {t}")
    return fn(_as_blocks(data, t, n_elements))


def _dec_q4_0(b: np.ndarray) -> Decoded:
    d = _scale_f16(b, 0)
    q = _nibbles(b[:, 2:18]).astype(np.int32)
    return Decoded(q, d, None, zero=8, gsize=32, bits=4)


def _dec_q4_1(b: np.ndarray) -> Decoded:
    d = _scale_f16(b, 0)
    m = _scale_f16(b, 2)
    q = _nibbles(b[:, 4:20]).astype(np.int32)
    return Decoded(q, d, m, zero=0, gsize=32, bits=4)


def _q5_high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """[nb, 4] bytes of the u32 qh -> [nb, 32] fifth-bit values (0/16).

    Bit j of qh is the high bit of element j (low-nibble half) and bit j+16
    of element j+16 (high-nibble half) — matching dequantize_row_q5_0.
    """
    qh = qh_bytes.copy().view("<u4").astype(np.uint32)  # [nb, 1]
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    return (((qh >> shifts) & 1) << 4).astype(np.int32)


def _dec_q5_0(b: np.ndarray) -> Decoded:
    d = _scale_f16(b, 0)
    q = _nibbles(b[:, 6:22]).astype(np.int32) | _q5_high_bits(b[:, 2:6])
    return Decoded(q, d, None, zero=16, gsize=32, bits=5)


def _dec_q5_1(b: np.ndarray) -> Decoded:
    d = _scale_f16(b, 0)
    m = _scale_f16(b, 2)
    q = _nibbles(b[:, 8:24]).astype(np.int32) | _q5_high_bits(b[:, 4:8])
    return Decoded(q, d, m, zero=0, gsize=32, bits=5)


def _dec_q8_0(b: np.ndarray) -> Decoded:
    d = _scale_f16(b, 0)
    q = b[:, 2:34].view(np.int8).astype(np.int32)
    return Decoded(q, d, None, zero=0, gsize=32, bits=8)


# --- K-quants --------------------------------------------------------------


def _dec_q2_k(b: np.ndarray) -> Decoded:
    nb = b.shape[0]
    scales = b[:, 0:16]  # u8[16]: low nibble scale, high nibble min
    qs = b[:, 16:80]  # u8[64], 2-bit packed
    d = _scale_f16(b, 80)
    dmin = _scale_f16(b, 82)

    # element order: half (2) x shift (4) x byte (32); 16-elem groups get
    # scale index = half*8 + shift*2 + (byte>=16)
    q = qs.reshape(nb, 2, 1, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8).reshape(1, 1, 4, 1)
    q2 = ((q >> shifts) & 3).astype(np.int32).reshape(nb, QK_K)

    sc = scales.astype(np.int32)  # group order == scale byte order
    dl = d * (sc & 0xF)  # [nb, 16]
    ml = dmin * (sc >> 4)
    return Decoded(q2, dl, -ml, zero=0, gsize=16, bits=2)


def _q3k_scales(sb: np.ndarray) -> np.ndarray:
    """[nb, 12] packed 6-bit scales -> [nb, 16] int32, bias 32 removed."""
    b = sb.astype(np.uint8)
    sc = np.empty((b.shape[0], 16), dtype=np.int32)
    sc[:, 0:4] = (b[:, 0:4] & 0xF) | ((b[:, 8:12] & 3) << 4)
    sc[:, 4:8] = (b[:, 4:8] & 0xF) | (((b[:, 8:12] >> 2) & 3) << 4)
    sc[:, 8:12] = (b[:, 0:4] >> 4) | (((b[:, 8:12] >> 4) & 3) << 4)
    sc[:, 12:16] = (b[:, 4:8] >> 4) | (((b[:, 8:12] >> 6) & 3) << 4)
    return sc - 32


def _dec_q3_k(b: np.ndarray) -> Decoded:
    nb = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales = _q3k_scales(b[:, 96:108])  # [nb,16]
    d = _scale_f16(b, 108)

    q = qs.reshape(nb, 2, 1, 32)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8).reshape(1, 1, 4, 1)
    q2 = ((q >> shifts) & 3).astype(np.int32)  # [nb, 2, 4, 32]

    # hmask bit index = half*4 + shift, byte = position within the 32-group;
    # q3 = low2 + 4*hbit, value = (q3 - 4) * dl
    hm = hmask.reshape(nb, 1, 1, 32)
    bit = (
        np.arange(2).reshape(1, 2, 1, 1) * 4 + np.arange(4).reshape(1, 1, 4, 1)
    ).astype(np.uint8)
    hbit = ((hm >> bit) & 1).astype(np.int32)
    q3 = (q2 | (hbit << 2)).reshape(nb, QK_K)
    return Decoded(q3, d * scales, None, zero=4, gsize=16, bits=3)


def _k4_scale_min(sb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """get_scale_min_k4 over all 8 sub-blocks: [nb,12] -> ([nb,8], [nb,8])."""
    q = sb.astype(np.uint8)
    sc = np.empty((q.shape[0], 8), dtype=np.int32)
    mn = np.empty((q.shape[0], 8), dtype=np.int32)
    sc[:, 0:4] = q[:, 0:4] & 63
    mn[:, 0:4] = q[:, 4:8] & 63
    sc[:, 4:8] = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    mn[:, 4:8] = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return sc, mn


def _dec_q4_k(b: np.ndarray) -> Decoded:
    nb = b.shape[0]
    d = _scale_f16(b, 0)
    dmin = _scale_f16(b, 2)
    sc, mn = _k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144]

    q = qs.reshape(nb, 4, 32)  # 4 chunks of 64 elements
    lo = (q & 0xF).astype(np.int32)
    hi = (q >> 4).astype(np.int32)
    qv = np.stack([lo, hi], axis=2).reshape(nb, QK_K)  # sub-block order
    return Decoded(qv, d * sc, -(dmin * mn), zero=0, gsize=32, bits=4)


def _dec_q5_k(b: np.ndarray) -> Decoded:
    nb = b.shape[0]
    d = _scale_f16(b, 0)
    dmin = _scale_f16(b, 2)
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48].reshape(nb, 1, 1, 32)
    qs = b[:, 48:176]

    q = qs.reshape(nb, 4, 32)
    lo = (q & 0xF).astype(np.int32)
    hi = (q >> 4).astype(np.int32)
    qv = np.stack([lo, hi], axis=2)  # [nb, 4, 2, 32]
    # chunk c, sub s uses qh bit 2c+s
    bit = (
        2 * np.arange(4).reshape(1, 4, 1, 1) + np.arange(2).reshape(1, 1, 2, 1)
    ).astype(np.uint8)
    hbit = ((qh >> bit) & 1).astype(np.int32)
    qv = (qv | (hbit << 4)).reshape(nb, QK_K)
    return Decoded(qv, d * sc, -(dmin * mn), zero=0, gsize=32, bits=5)


def _dec_q6_k(b: np.ndarray) -> Decoded:
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 64)  # per half: 64 bytes
    qh = b[:, 128:192].reshape(nb, 2, 32)
    scales = b[:, 192:208].view(np.int8).astype(np.int32).reshape(nb, 2, 8)
    d = _scale_f16(b, 208)  # [nb,1]

    l32 = ql[:, :, 0:32].astype(np.int32)
    h32 = ql[:, :, 32:64].astype(np.int32)
    hq = qh.astype(np.int32)
    q1 = (l32 & 0xF) | (((hq >> 0) & 3) << 4)  # elems   0..31 of half
    q2 = (h32 & 0xF) | (((hq >> 2) & 3) << 4)  # elems  32..63
    q3 = (l32 >> 4) | (((hq >> 4) & 3) << 4)  # elems  64..95
    q4 = (h32 >> 4) | (((hq >> 6) & 3) << 4)  # elems  96..127
    qv = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, QK_K)

    # scale idx within half for the 4 rows of 32: [0,2,4,6] + l//16
    sidx = np.array([0, 2, 4, 6]).reshape(4, 1) + (np.arange(2) // 1).reshape(1, 2)
    sc = scales[:, :, sidx].reshape(nb, 16)  # [nb, 2, 4, 2] -> group order
    return Decoded(qv, d * sc, None, zero=32, gsize=16, bits=6)


_DECODE = {
    GgmlType.Q4_0: _dec_q4_0,
    GgmlType.Q4_1: _dec_q4_1,
    GgmlType.Q5_0: _dec_q5_0,
    GgmlType.Q5_1: _dec_q5_1,
    GgmlType.Q8_0: _dec_q8_0,
    GgmlType.Q2_K: _dec_q2_k,
    GgmlType.Q3_K: _dec_q3_k,
    GgmlType.Q4_K: _dec_q4_k,
    GgmlType.Q5_K: _dec_q5_k,
    GgmlType.Q6_K: _dec_q6_k,
}


# ---------------------------------------------------------------------------
# float dequantization (derived from the canonical decoding)


def dequantize(t: GgmlType, data: bytes | np.ndarray, n_elements: int) -> np.ndarray:
    """Decode `n_elements` of on-disk type `t` from `data` into float32."""
    if t == GgmlType.F32:
        return np.frombuffer(data, dtype="<f4", count=n_elements).copy()
    if t == GgmlType.F16:
        return np.frombuffer(data, dtype="<f2", count=n_elements).astype(np.float32)
    if t == GgmlType.I8:
        return np.frombuffer(data, dtype=np.int8, count=n_elements).astype(np.float32)
    if t == GgmlType.I16:
        return np.frombuffer(data, dtype="<i2", count=n_elements).astype(np.float32)
    if t == GgmlType.I32:
        return np.frombuffer(data, dtype="<i4", count=n_elements).astype(np.float32)
    return decode_blocks(t, data, n_elements).to_float().reshape(-1)


# ---------------------------------------------------------------------------
# quantization (targets permitted by the reference quantizer,
# llm-base/src/quantize.rs:224-244: Q4_0/Q4_1/Q5_0/Q5_1/Q8_0)


def quantize(t: GgmlType, x: np.ndarray) -> bytes:
    """Encode float32 array into on-disk type `t` (ggml rounding semantics)."""
    data, _ = quantize_with_hist(t, x, want_hist=False)
    return data


def quantize_with_hist(
    t: GgmlType, x: np.ndarray, want_hist: bool = True
) -> tuple[bytes, np.ndarray]:
    """Quantize and return (bytes, histogram[16]) like ggml_quantize_*.

    `want_hist=False` skips the histogram (np.bincount's internal intp
    conversion is ~half of total encode time at 7B scale)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if t == GgmlType.F32:
        return x.astype("<f4").tobytes(), np.zeros(16, dtype=np.int64)
    if t == GgmlType.F16:
        return x.astype("<f2").tobytes(), np.zeros(16, dtype=np.int64)
    fn = _QUANT.get(t)
    if fn is None:
        raise NotImplementedError(f"quantize for {t}")
    bs = block_size(t)
    if x.size % bs != 0:
        raise ValueError(f"{x.size} not a multiple of block size {bs} for {t}")
    xb = x.reshape(-1, bs)
    return fn(xb, want_hist)


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Per-row value with the largest magnitude (keeping its sign).

    ggml keeps the *signed* value of the first strict-max |x| element.
    """
    idx = np.argmax(np.abs(xb), axis=1)
    return xb[np.arange(xb.shape[0]), idx]


def _hist_maybe(want: bool, vals: np.ndarray, shift: int = 0) -> np.ndarray:
    return _hist(vals, shift) if want else np.zeros(16, dtype=np.int64)


def _hist(vals: np.ndarray, nbins_shift: int = 0) -> np.ndarray:
    # bincount the narrow dtype directly — an int64 conversion here was
    # 85% of total quantize time at 7B scale
    v = vals.reshape(-1)
    if nbins_shift:
        v = v >> nbins_shift
    return np.bincount(v, minlength=16)[:16].astype(np.int64)


def _qz_q4_0(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    maxv = _signed_absmax(xb)
    d = maxv / -8.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(15, (xb * inv[:, None] + 8.5).astype(np.int8)).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:18] = _pack_nibbles(q)
    return out.tobytes(), _hist_maybe(want_hist, q)


def _qz_q4_1(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(15, ((xb - mn[:, None]) * inv[:, None] + 0.5).astype(np.int8)).astype(
        np.uint8
    )
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype("<f2")[:, None].view(np.uint8)
    out[:, 4:20] = _pack_nibbles(q)
    return out.tobytes(), _hist_maybe(want_hist, q)


def _pack_q5(q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[nb,32] 5-bit values -> (qs [nb,16], qh [nb,4] bytes of u32)."""
    nibs = _pack_nibbles(q & 0xF)
    hi = ((q >> 4) & 1).astype(np.uint32)  # [nb, 32], element-order bits
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    qh = (hi << shifts).sum(axis=1, dtype=np.uint32)
    return nibs, qh[:, None].view(np.uint8).reshape(-1, 4)


def _qz_q5_0(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    maxv = _signed_absmax(xb)
    d = maxv / -16.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(31, (xb * inv[:, None] + 16.5).astype(np.int8)).astype(np.uint8)
    qs, qh = _pack_q5(q)
    out = np.empty((nb, 22), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:6] = qh
    out[:, 6:22] = qs
    return out.tobytes(), _hist_maybe(want_hist, q, 1)


def _qz_q5_1(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(31, ((xb - mn[:, None]) * inv[:, None] + 0.5).astype(np.int8)).astype(
        np.uint8
    )
    qs, qh = _pack_q5(q)
    out = np.empty((nb, 24), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype("<f2")[:, None].view(np.uint8)
    out[:, 4:8] = qh
    out[:, 8:24] = qs
    return out.tobytes(), _hist_maybe(want_hist, q, 1)


def _qz_q8_0(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    # roundf: round half away from zero = trunc(x + copysign(0.5, x))
    scaled = xb * inv[:, None]
    q = np.trunc(scaled + np.copysign(np.float32(0.5), scaled)).astype(np.int8)
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes(), _hist_maybe(want_hist, (q.astype(np.int16) + 128).astype(np.uint8) >> 4)


# ---------------------------------------------------------------------------
# K-quant encoders (reference surface: ggml_quantize_q2_K..q6_K,
# llm/crates/ggml/sys/src/lib.rs:3472-3516). Vectorized numpy
# ports of the k_quants.c two-level scheme: per-sub-block float scales fit
# by iterative weighted least squares, then snapped to the super-block's
# 4/6/8-bit scale grid, then codes re-derived from the SNAPPED scales so
# encode->decode is self-consistent. The per-coordinate greedy RMSE search
# of make_q3_quants is replaced by the same candidate-scale sweep
# make_qx_quants uses (vectorizable; equal structure, near-equal quality) —
# bit-exactness with the C encoder is not a format requirement (any valid
# block stream decodes identically everywhere).


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int(): round half to even (the +12582912f trick)."""
    return np.rint(x).astype(np.int32)


def _make_qkx1(x: np.ndarray, nmax: int, ntry: int = 5):
    """Vectorized make_qkx1_quants over rows: fit value = scale*q + min with
    q in [0, nmax], min <= 0. Returns (scale [N], the_min [N] = -min, L [N,n]).
    """
    n = x.shape[1]
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    flat = mx == mn
    mn = np.minimum(mn, 0.0)
    rng = np.where(flat, 1.0, mx - mn)
    iscale = np.where(flat, 0.0, nmax / rng)
    scale = np.where(iscale != 0, 1.0 / np.where(iscale == 0, 1, iscale), 0.0)
    L = np.zeros(x.shape, np.int32)
    # flat block with positive DC: representable exactly as scale*nmax
    # (min is clamped to <= 0, so the min path can't carry it; the C code's
    # max==min early-exit silently zeroes such blocks — a quality bug we
    # do not reproduce)
    flat_pos = flat & (mx > 0)
    scale = np.where(flat_pos, mx / nmax, scale)
    L = np.where(flat_pos[:, None], nmax, L)
    active = ~flat
    for _ in range(ntry):
        if not active.any():
            break
        l = np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])), 0, nmax)
        changed = (l != L).any(axis=1) & active
        L = np.where(active[:, None], l, L)
        sumlx = ((x - mn[:, None]) * L).sum(axis=1)
        suml2 = (L * L).sum(axis=1)
        new_scale = np.where(suml2 > 0, sumlx / np.where(suml2 == 0, 1, suml2), 0.0)
        scale = np.where(active, new_scale, scale)
        resid = (x - scale[:, None] * L).sum(axis=1)
        mn = np.where(active, np.minimum(resid / n, 0.0), mn)
        iscale = np.where(scale != 0, 1.0 / np.where(scale == 0, 1, scale), 0.0)
        active = active & changed
    return scale, -mn, L


def _make_qx(x: np.ndarray, nmax: int, lo: int | None = None):
    """Vectorized make_qx_quants (rmse_type=1): symmetric fit value=scale*q,
    q in [lo, nmax-1] (lo defaults to -nmax), weights x^2, candidate sweep
    over iscale = -(nmax + 0.1*is)/max for is in 0, -4..4. Returns
    (scale [N], L [N, n] with q + nmax offset NOT applied)."""
    if lo is None:
        lo = -nmax
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    dead = maxv == 0
    safe_max = np.where(dead, 1.0, maxv)
    w = x * x
    # candidate order matters only for ties; base (is=0) first like the C
    cands = np.array([0, -4, -3, -2, -1, 1, 2, 3, 4], np.float32)
    iscales = -(nmax + 0.1 * cands)[None, :] / safe_max[:, None]  # [N, 9]
    l = np.clip(
        _nearest_int(iscales[:, :, None] * x[:, None, :]), lo, nmax - 1
    )  # [N, 9, n]
    sumlx = (w[:, None, :] * x[:, None, :] * l).sum(axis=2)
    suml2 = (w[:, None, :] * l * l).sum(axis=2)
    obj = np.where(suml2 > 0, sumlx * sumlx / np.where(suml2 == 0, 1, suml2), -1.0)
    best = np.argmax(obj, axis=1)
    ar = np.arange(x.shape[0])
    L = l[ar, best]
    s2 = suml2[ar, best]
    scale = np.where(s2 > 0, sumlx[ar, best] / np.where(s2 == 0, 1, s2), 0.0)
    scale = np.where(dead, 0.0, scale)
    L = np.where(dead[:, None], 0, L)
    return scale, L


def _f16_round(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).astype(np.float32)


def _pack_2bit(L: np.ndarray) -> np.ndarray:
    """[nb, 256] 2-bit codes in linear order -> qs [nb, 64] (q2/q3 layout:
    element e = half*128 + shift*32 + byte)."""
    nb = L.shape[0]
    v = L.reshape(nb, 2, 4, 32).astype(np.uint8)
    shifts = np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    return (v << shifts).sum(axis=2, dtype=np.uint8).reshape(nb, 64)


def _qz_q2_k(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    scale, minv, _ = _make_qkx1(xb.reshape(nb * 16, 16), 3, ntry=5)
    scales = scale.reshape(nb, 16)
    mins = minv.reshape(nb, 16)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    q4 = 15.0
    inv_s = np.where(max_scale > 0, q4 / np.where(max_scale == 0, 1, max_scale), 0.0)
    inv_m = np.where(max_min > 0, q4 / np.where(max_min == 0, 1, max_min), 0.0)
    ls = np.clip(_nearest_int(inv_s[:, None] * scales), 0, 15)
    lm = np.clip(_nearest_int(inv_m[:, None] * mins), 0, 15)
    d = _f16_round(np.where(max_scale > 0, max_scale / q4, 0.0))
    dmin = _f16_round(np.where(max_min > 0, max_min / q4, 0.0))
    # re-derive codes from the snapped scales
    dl = d[:, None] * ls  # [nb, 16]
    dm = dmin[:, None] * lm
    dl_r = np.repeat(dl, 16, axis=1)
    dm_r = np.repeat(dm, 16, axis=1)
    L = np.where(
        dl_r != 0,
        np.clip(
            _nearest_int((xb + dm_r) / np.where(dl_r == 0, 1, dl_r)), 0, 3
        ),
        0,
    )
    out = np.empty((nb, 84), np.uint8)
    out[:, 0:16] = (ls | (lm << 4)).astype(np.uint8)
    out[:, 16:80] = _pack_2bit(L)
    out[:, 80:82] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 82:84] = dmin.astype("<f2")[:, None].view(np.uint8)
    return out.tobytes(), _hist_maybe(want_hist, L)


def _pack_q3k_scales(ls: np.ndarray) -> np.ndarray:
    """[nb, 16] 6-bit values (0..63) -> [nb, 12] packed bytes (inverse of
    _q3k_scales)."""
    nb = ls.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    lo = (ls & 0xF).astype(np.uint8)
    hi = (ls >> 4).astype(np.uint8)
    out[:, 0:4] = lo[:, 0:4] | (lo[:, 8:12] << 4)
    out[:, 4:8] = lo[:, 4:8] | (lo[:, 12:16] << 4)
    out[:, 8:12] = (
        hi[:, 0:4]
        | (hi[:, 4:8] << 2)
        | (hi[:, 8:12] << 4)
        | (hi[:, 12:16] << 6)
    )
    return out


def _qz_q3_k(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    scale, _ = _make_qx(xb.reshape(nb * 16, 16), 4)
    scales = scale.reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]
    has = max_scale != 0
    iscale = np.where(has, -32.0 / np.where(max_scale == 0, 1, max_scale), 0.0)
    ls6 = np.clip(_nearest_int(iscale[:, None] * scales), -32, 31) + 32
    ls6 = np.where(has[:, None], ls6, 32)  # encodes sc=0 after bias removal
    d = _f16_round(np.where(has, 1.0 / np.where(iscale == 0, 1, iscale), 0.0))
    dl = d[:, None] * (ls6 - 32)  # effective per-group scale
    dl_r = np.repeat(dl, 16, axis=1)
    q = np.where(
        dl_r != 0,
        np.clip(_nearest_int(xb / np.where(dl_r == 0, 1, dl_r)), -4, 3),
        0,
    )
    L = q + 4  # 3-bit codes 0..7
    hbit = (L >> 2).astype(np.uint8)  # [nb, 256] in linear order
    # hmask byte = e % 32, bit = e // 32
    hmask = (
        (hbit.reshape(nb, 8, 32) << np.arange(8, dtype=np.uint8).reshape(1, 8, 1))
        .sum(axis=1, dtype=np.uint8)
    )
    out = np.empty((nb, 110), np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = _pack_2bit(L & 3)
    out[:, 96:108] = np.where(has[:, None], _pack_q3k_scales(ls6), 0)
    out[:, 108:110] = d.astype("<f2")[:, None].view(np.uint8)
    return out.tobytes(), _hist_maybe(want_hist, L, 0)


def _pack_k4_scale_min(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """[nb, 8] 6-bit scales + [nb, 8] 6-bit mins -> [nb, 12] packed bytes
    (inverse of _k4_scale_min / get_scale_min_k4)."""
    nb = sc.shape[0]
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros((nb, 12), np.uint8)
    out[:, 0:4] = (sc[:, 0:4] & 63) | ((sc[:, 4:8] >> 4) << 6)
    out[:, 4:8] = (mn[:, 0:4] & 63) | ((mn[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:8] & 0xF) | ((mn[:, 4:8] & 0xF) << 4)
    return out


def _k45_encode_common(xb: np.ndarray, nmax: int):
    """Shared Q4_K/Q5_K path: fit 8 sub-blocks of 32, snap scales/mins to
    6 bits, re-derive codes. Returns (d, dmin, packed_scales, L [nb, 256])."""
    nb = xb.shape[0]
    scale, minv, _ = _make_qkx1(xb.reshape(nb * 8, 32), nmax, ntry=5)
    scales = scale.reshape(nb, 8)
    mins = minv.reshape(nb, 8)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    inv_s = np.where(max_scale > 0, 63.0 / np.where(max_scale == 0, 1, max_scale), 0.0)
    inv_m = np.where(max_min > 0, 63.0 / np.where(max_min == 0, 1, max_min), 0.0)
    ls = np.minimum(63, _nearest_int(inv_s[:, None] * scales))
    lm = np.minimum(63, _nearest_int(inv_m[:, None] * mins))
    d = _f16_round(max_scale / 63.0)
    dmin = _f16_round(max_min / 63.0)
    dl = d[:, None] * ls
    dm = dmin[:, None] * lm
    dl_r = np.repeat(dl, 32, axis=1)
    dm_r = np.repeat(dm, 32, axis=1)
    L = np.where(
        dl_r != 0,
        np.clip(
            _nearest_int((xb + dm_r) / np.where(dl_r == 0, 1, dl_r)), 0, nmax
        ),
        0,
    )
    return d, dmin, _pack_k4_scale_min(ls, lm), L


def _qz_q4_k(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    d, dmin, sm, L = _k45_encode_common(xb, 15)
    v = L.reshape(nb, 4, 2, 32).astype(np.uint8)  # [nb, chunk, sub, byte]
    qs = (v[:, :, 0] | (v[:, :, 1] << 4)).reshape(nb, 128)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype("<f2")[:, None].view(np.uint8)
    out[:, 4:16] = sm
    out[:, 16:144] = qs
    return out.tobytes(), _hist_maybe(want_hist, L)


def _qz_q5_k(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    d, dmin, sm, L = _k45_encode_common(xb, 31)
    v = L.reshape(nb, 4, 2, 32).astype(np.uint8)
    lo = v & 0xF
    qs = (lo[:, :, 0] | (lo[:, :, 1] << 4)).reshape(nb, 128)
    # qh bit 2c+s for chunk c, sub s
    hb = (v >> 4).astype(np.uint8)  # [nb, 4, 2, 32]
    bit = (
        2 * np.arange(4).reshape(1, 4, 1, 1) + np.arange(2).reshape(1, 1, 2, 1)
    ).astype(np.uint8)
    qh = (hb << bit).sum(axis=(1, 2), dtype=np.uint8)  # [nb, 32]
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype("<f2")[:, None].view(np.uint8)
    out[:, 4:16] = sm
    out[:, 16:48] = qh
    out[:, 48:176] = qs
    return out.tobytes(), _hist_maybe(want_hist, L, 1)


def _qz_q6_k(xb: np.ndarray, want_hist: bool = True) -> tuple[bytes, np.ndarray]:
    nb = xb.shape[0]
    scale, _ = _make_qx(xb.reshape(nb * 16, 16), 32)
    scales = scale.reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]
    has = max_scale != 0
    iscale = np.where(has, -128.0 / np.where(max_scale == 0, 1, max_scale), 0.0)
    d = _f16_round(np.where(has, 1.0 / np.where(iscale == 0, 1, iscale), 0.0))
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    sc8 = np.where(has[:, None], sc8, 0).astype(np.int8)
    dl = d[:, None] * sc8.astype(np.float32)
    dl_r = np.repeat(dl, 16, axis=1)
    q = np.where(
        dl_r != 0,
        np.clip(_nearest_int(xb / np.where(dl_r == 0, 1, dl_r)), -32, 31),
        0,
    )
    L = (q + 32).astype(np.uint8)  # [nb, 256], 6-bit codes
    v = L.reshape(nb, 2, 4, 32)  # [nb, half, row, byte]
    lo = v & 0xF
    hi = v >> 4  # 2 bits
    ql = np.empty((nb, 2, 64), np.uint8)
    ql[:, :, 0:32] = lo[:, :, 0] | (lo[:, :, 2] << 4)
    ql[:, :, 32:64] = lo[:, :, 1] | (lo[:, :, 3] << 4)
    qh = (
        hi[:, :, 0] | (hi[:, :, 1] << 2) | (hi[:, :, 2] << 4) | (hi[:, :, 3] << 6)
    )  # [nb, 2, 32]
    out = np.empty((nb, 210), np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d.astype("<f2")[:, None].view(np.uint8)
    return out.tobytes(), _hist_maybe(want_hist, L, 2)


_QUANT = {
    GgmlType.Q4_0: _qz_q4_0,
    GgmlType.Q4_1: _qz_q4_1,
    GgmlType.Q5_0: _qz_q5_0,
    GgmlType.Q5_1: _qz_q5_1,
    GgmlType.Q8_0: _qz_q8_0,
    GgmlType.Q2_K: _qz_q2_k,
    GgmlType.Q3_K: _qz_q3_k,
    GgmlType.Q4_K: _qz_q4_k,
    GgmlType.Q5_K: _qz_q5_k,
    GgmlType.Q6_K: _qz_q6_k,
}

# The reference CLI quantizer only permits the scalar formats
# (quantize.rs:224-244); the K-quant encoders exist for LoRA requantize and
# programmatic use (ggml_quantize_q2_K..q6_K surface).
QUANTIZE_TARGETS = (
    GgmlType.Q4_0,
    GgmlType.Q4_1,
    GgmlType.Q5_0,
    GgmlType.Q5_1,
    GgmlType.Q8_0,
)
KQUANT_TARGETS = (
    GgmlType.Q2_K,
    GgmlType.Q3_K,
    GgmlType.Q4_K,
    GgmlType.Q5_K,
    GgmlType.Q6_K,
)
