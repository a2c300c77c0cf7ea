"""The tensor-core qmatmul kernel's host side and arithmetic, on the CPU.

The kernel itself (csrc/qmatmul_tc.cuh) runs only on the card; chip_smoke.py
holds it against its plain version there. Here:

- `qmatmul.plan` gives a legal tiling for every LLaMA-7B projection at the
  main path's M and for small shapes of all 10 formats, and the same tiling
  for a weight and for `coalesce_auto(weight)` (whose R is padded wider):
  the condition of K3 being bit-equal to K1. The wide path's (wgmma, TMA)
  layout is legal for every format at every 7B shape and M > 32: shared
  memory within a block's 227 KB, x's tensor map (16-byte strides, boxes
  of at most 256), the splits covering K; its 128-byte swizzle, mirrored
  here, puts each 16-byte chunk of a tile in its own place and agrees with
  the address-based swizzle that TMA writes and wgmma reads at every k
  step of the descriptors.
- A plain walk of a plan's tiles, with the K splits summed in order, covers
  every (k, r) exactly once and equals `qmatmul_plain` to f32 rounding
  (rtol 1e-5: the same products summed in another order).
- The chip probes' cuts and modes launch on K1's own plan: the probe
  module's plan and buffers at each probe's 7B shape and at the main
  path's M equal `qmatmul.plan`'s, x staged as K1 stages it.
- The producer's arithmetic, written here as plain torch on the int32 words
  the kernel reads (the field ORed into the mantissa of 2^23, minus 2^23 +
  zero, times scale * 2^-p for a field at bit p, bias added, rounded to
  bf16 once), equals `packing.dequant(...).bfloat16()` bit for bit for all
  10 formats, both scale kinds and both layouts.
- Cross-checks against the reference: the walk of a 7B-shaped plan's split
  over a tiny weight equals the JAX package's `dequant_jnp` product.
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_tpu.ggml.types import GgmlType
from llm_tpu.ops import packing as jpk
from llm_tpu_torch.ops import packing as tpk
from llm_tpu_torch.ops import qmatmul as tqm
from llm_tpu_torch.ops import qmatmul_probe as qp
from llm_tpu_torch.probes import kernel_report
from test_torch_packing import ALL_TYPES, random_raw

E, FF, V = 4096, 11008, 32000
SHAPES_7B = {"qkv": (E, 3 * E), "wo": (E, E), "gate_up": (E, 2 * FF),
             "down": (FF, E), "lm_head": (E, V)}
MAIN_MS = (1, 8, 16, 64, 512)


def padded_k(K: int) -> int:
    """Q4_0's padded K (the reference's granule: 512 above K = 512)."""
    fmt = tpk.FORMATS[GgmlType.Q4_0]
    return -(-K // tpk.k_granule(fmt, K)) * tpk.k_granule(fmt, K)


def assert_legal(p: tqm.Plan, M: int, K_padded: int, R: int, fmt,
                 sms: int) -> None:
    n_kt = K_padded // tqm.BK
    assert K_padded % tqm.BK == 0
    assert p.path == ("swapped8" if M <= 8 else "swapped16" if M <= 32
                      else "wide")
    assert p.bm == ({"swapped8": 8, "swapped16": 16}[p.path]
                    if p.path != "wide" else
                    64 if M <= 64 else 128 if M <= 128 else 256)
    assert p.mtiles == math.ceil(M / p.bm)
    assert p.rblocks == math.ceil(R / tqm.BN)
    # every split holds at least one tile, and the splits cover K
    assert 1 <= p.tiles_per_split <= n_kt
    assert (p.splits - 1) * p.tiles_per_split < n_kt
    assert p.splits * p.tiles_per_split >= n_kt
    cap = tqm.blocks_per_sm(fmt, p.path, p.bm) * sms
    regs = tqm.REG_BLOCKS[p.path]
    assert 1 <= tqm.blocks_per_sm(fmt, p.path, p.bm) <= (
        regs[p.bm] if p.path == "wide" else regs)
    if p.path == "wide" and p.splits > 1:  # splits only within one wave
        assert p.rblocks * p.mtiles * p.splits <= cap


def assert_least_time(p: tqm.Plan, K_padded: int, fmt, sms: int) -> None:
    """No other split runs fewer waves x (tiles a block + fill)."""
    n_kt = K_padded // tqm.BK
    cap = tqm.blocks_per_sm(fmt, p.path, p.bm) * sms
    blocks = p.rblocks * p.mtiles

    def cost(splits, tps):
        return math.ceil(blocks * splits / cap) * (tps + tqm.FILL_TILES)

    mine = cost(p.splits, p.tiles_per_split)
    for s in range(1, n_kt + 1):
        tps = math.ceil(n_kt / s)
        s2 = math.ceil(n_kt / tps)
        if p.path == "wide" and s2 > 1 and blocks * s2 > cap:
            continue
        assert mine <= cost(s2, tps), (p, s2, tps)


@pytest.mark.parametrize("M", MAIN_MS)
@pytest.mark.parametrize("name", list(SHAPES_7B))
def test_plan_legal_at_7b(name, M):
    K, R = SHAPES_7B[name]
    fmt = tpk.FORMATS[GgmlType.Q4_0]
    w = SimpleNamespace(k=K, r=R, k_padded=padded_k(K),
                        r_padded=-(-R // 128) * 128, fmt=fmt)
    p = tqm.plan(w, M, sms=132)
    assert_legal(p, M, w.k_padded, R, fmt, 132)
    assert_least_time(p, w.k_padded, fmt, 132)
    # the blocks a launch runs (grid x splits) fill the card; on the wide
    # path as far as one more split would not make a second wave
    blocks = p.rblocks * p.mtiles
    cap = tqm.blocks_per_sm(fmt, p.path, p.bm) * 132
    assert blocks * p.splits >= 132 or (
        p.path == "wide" and blocks * (p.splits + 1) > cap)


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_plan_legal_small_all_formats(t):
    tq = tpk.pack_ggml(t, random_raw(t, 512, 200, seed=3), (512, 200))
    for M in (1, 4, 8, 16, 32, 33, 64, 512):
        for sms in (1, 132):
            p = tqm.plan(tq, M, sms=sms)
            assert_legal(p, M, tq.k_padded, tq.r, tq.fmt, sms)
            assert_least_time(p, tq.k_padded, tq.fmt, sms)
            # the f32-scale instantiation plans alike
            if tq.scale_packed:
                assert p == tqm.plan(tpk.unpack_scales_qt(tq), M, sms=sms)


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q8_0, GgmlType.Q6_K],
                         ids=lambda t: t.name)
def test_plan_same_for_coalesce_auto(t):
    """R = 2600 packs to 2688 planes and to 2816 lanes coalesced (R padded
    to 256s): the plan reads neither."""
    K, R = 2048, 2600
    tq = tpk.pack_ggml(t, random_raw(t, K, R, seed=5), (K, R))
    qc = tqm.coalesce_auto(tq)
    assert qc is not None and qc.r_padded > tq.r_padded
    assert qc.tile_k % tqm.BK == 0
    for M in MAIN_MS + (4, 32, 100):
        for sms in (8, 132):
            assert tqm.plan(tq, M, sms) == tqm.plan(qc, M, sms)


WIDE_MS = (33, 64, 65, 128, 512)


@pytest.mark.parametrize("M", WIDE_MS)
@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_wide_plan_legal_every_format_at_7b(t, M):
    """Every format, both scale kinds, at every 7B projection: the wgmma
    path's shared memory, x's tensor map and the split cover."""
    fmt = tpk.FORMATS[t]
    for name, (K, R) in SHAPES_7B.items():
        g = tpk.k_granule(fmt, K)
        w = SimpleNamespace(k=K, r=R, k_padded=-(-K // g) * g,
                            r_padded=-(-R // 128) * 128, fmt=fmt)
        p = tqm.plan(w, M, sms=132)
        assert_legal(p, M, w.k_padded, R, fmt, 132)
        assert_least_time(p, w.k_padded, fmt, 132)
        # the packed ring several k-tiles deep (the bytes in flight), the
        # x ring 2 ahead
        n = tqm.wide_pstages(fmt, p.bm)
        assert 3 <= n <= tqm.WIDE_MAX_PSTAGES  # copies PS - 1 ahead
        smem = tqm.smem_bytes(fmt, "wide", p.bm)
        assert smem <= tqm.WIDE_SMEM_MAX[p.bm]
        # two blocks an SM at bm = 64, else one
        assert tqm.blocks_per_sm(fmt, "wide", p.bm) == (2 if p.bm == 64
                                                         else 1)
        # the x and weight tiles start on 1 KB, the swizzle's period; the
        # packed stages on 16 bytes (the copies')
        assert (p.bm * tqm.BK * 2) % 1024 == 0
        assert tqm.packed_tile_bytes(fmt) % 16 == 0
        # x's tensor map: [M, K] bf16, rows of whole 16-byte chunks (the
        # global stride), a box of 64 x bm, each dimension at most 256, the
        # inner one 128 bytes (the swizzle's span)
        assert (K * 2) % 16 == 0
        assert tqm.BK * 2 == 128 and 0 < p.bm <= 256 and tqm.BK <= 256
        # two warpgroups share the block's rows (64: both all 64 rows, half
        # the weight columns each; 128, 256: half the rows each, in wgmma
        # tiles of 64)
        assert p.bm in (64, 128, 256) and (p.bm == 64 or p.bm // 2 % 64 == 0)


def swz(row: int, chunk: int) -> int:
    """csrc/qmatmul_tc.cuh swz: the byte offset of 16-byte chunk `chunk`
    (8 bf16 of k) of row `row` of a [rows][64] bf16 tile."""
    return row * (tqm.BK * 2) + ((chunk ^ (row & 7)) << 4)


def sw128(addr: int) -> int:
    """The 128-byte swizzle on a shared address (TMA's
    CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout 1): bits [4, 7) ^= [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("rows", [64, 128, 256])
def test_wide_swizzle_mirror(rows):
    """Every (row, k) of an x tile (64, 128 or 256 rows) or of the 128-row
    weight tile lands in one distinct 16-byte chunk; the chunk the dequant
    writes is the one TMA's swizzle puts there, and the one wgmma reads
    from the descriptor start + 32 ks bytes (the k step of 16) with its own
    address swizzle, for a tile on 1 KB."""
    base = 5 * 1024
    seen = {}
    for r in range(rows):
        for k in range(tqm.BK):
            chunk, within = k // 8, (k % 8) * 2
            at = swz(r, chunk)
            seen.setdefault(at, set()).add((r, chunk))
            assert base + at + within == sw128(base + r * 128 + 2 * k)
            ks, kk = divmod(k, 16)
            start = base + 32 * ks  # the descriptor of k step ks
            assert sw128(start + r * 128 + 2 * kk) == base + at + within
    assert len(seen) == rows * tqm.BK // 8
    assert all(len(v) == 1 for v in seen.values())
    assert max(seen) + 16 == rows * tqm.BK * 2


def walk(x: torch.Tensor, wd: torch.Tensor, p: tqm.Plan,
         cover: torch.Tensor) -> torch.Tensor:
    """y = x @ wd (wd f32 [Kp, Rp]) tile by tile as the plan's grid runs
    it: each split sums its 64-k tiles in order into its partial, the
    partials are summed in split order; `cover` [Kp, R rounded to BN]
    counts the (k, r) each block reads once."""
    M, Kp = x.shape[0], wd.shape[0]
    ldo = p.rblocks * tqm.BN
    xp = torch.zeros((p.mtiles * p.bm, Kp), dtype=torch.float32)
    xp[:M, : x.shape[1]] = x
    wp = torch.zeros((Kp, ldo), dtype=torch.float32)
    wp[:, : min(ldo, wd.shape[1])] = wd[:, :ldo]
    parts = []
    for z in range(p.splits):
        part = torch.zeros((p.mtiles * p.bm, ldo), dtype=torch.float32)
        for rb in range(p.rblocks):
            cols = slice(rb * tqm.BN, (rb + 1) * tqm.BN)
            for mt in range(p.mtiles):
                rows = slice(mt * p.bm, (mt + 1) * p.bm)
                for kt in range(z * p.tiles_per_split,
                                min((z + 1) * p.tiles_per_split,
                                    Kp // tqm.BK)):
                    ks = slice(kt * tqm.BK, (kt + 1) * tqm.BK)
                    part[rows, cols] += xp[rows, ks] @ wp[ks, cols]
                    if mt == 0:
                        cover[ks, cols] += 1
        parts.append(part)
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y[:M]


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_plan_walk_covers_once_and_equals_plain(t):
    K, R = 512, 300
    tq = tpk.pack_ggml(t, random_raw(t, K, R, seed=9), (K, R))
    wd = tpk.dequant(tq, trim=False)
    rng = np.random.default_rng(10)
    for M, sms in ((1, 1), (5, 132), (20, 2), (40, 1), (100, 2), (130, 132),
                   (300, 1)):
        p = tqm.plan(tq, M, sms)
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
        cover = torch.zeros((tq.k_padded, p.rblocks * tqm.BN),
                            dtype=torch.int32)
        y = walk(x, wd, p, cover)
        assert bool((cover == 1).all()), (M, sms, p)
        ref = tqm.qmatmul_plain(x, tq)
        np.testing.assert_allclose(y[:, :R].numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


def test_walk_of_a_split_7b_plan_matches_reference():
    """A tiny weight planned as if it were wo at M = 1 on 132 SMs: many K
    splits of one tile or more; the walk equals the reference's plain
    dequantized product."""
    t, K, R = GgmlType.Q4_0, 1024, 256
    raw = random_raw(t, K, R, seed=12)
    tq = tpk.pack_ggml(t, raw, (K, R))
    jq = jpk.pack_ggml(t, raw, (K, R))
    p = tqm.plan(tq, 1, 132)
    assert p.splits == K // tqm.BK and p.tiles_per_split == 1
    x = np.random.default_rng(13).standard_normal((1, K)).astype(np.float32)
    cover = torch.zeros((K, R), dtype=torch.int32)
    y = walk(torch.from_numpy(x), tpk.dequant(tq, trim=False), p, cover)
    ref = x @ np.asarray(jpk.dequant_jnp(jq))
    assert bool((cover == 1).all())
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


# the probes' 7B weights (K padded, R, R padded): P2's planes, P1's planes
# at up and down, P3's coalesced buffer (R packed to 1024s)
PROBE_SHAPES = {"p2": (4096, 4096, 4096), "p1_up": (4096, 11008, 11008),
                "p1_down": (11264, 4096, 4096), "p3": (4096, 11008, 11264)}


@pytest.mark.parametrize("M", [1, 8, 16, 64, 512])
@pytest.mark.parametrize("shape", list(PROBE_SHAPES))
def test_probe_launches_on_k1s_plan(shape, M):
    """A cut runs K1's plan at its M, x as K1 reads it (f32 on the swapped
    path, bf16 on the wide one), one value a column of Rp per split and
    m-tile; a mode runs only on the swapped path at 8 tokens a block."""
    Kp, R, Rp = PROBE_SHAPES[shape]
    w = SimpleNamespace(fmt_name="q4_0", fmt=tpk.FORMATS[GgmlType.Q4_0],
                        scale_packed=True, k=Kp, r=R, k_padded=Kp,
                        r_padded=Rp)
    want = tqm.plan(w, M, 132)
    x = torch.zeros((M, Kp))
    for stage, dt in (("stream", torch.int32), ("dequant", torch.float32)):
        p, xk, part, out = qp.stage_buffers(w, stage, x, 132)
        assert p == want
        assert xk.dtype == (torch.bfloat16 if p.path == "wide"
                            else torch.float32)
        assert part.shape == (p.splits, p.mtiles, Rp) and part.dtype == dt
        assert out.shape == (Rp,) and out.dtype == dt
    if want.path != "swapped8":
        with pytest.raises(ValueError, match="8 tokens a block"):
            _mode_buffers(w, x)
    else:
        p, xk, y, part = _mode_buffers(w, x)
        assert p == want and xk.dtype == torch.float32
        assert y.shape == (M, R)
        assert (part is None) == (p.splits == 1)


def _mode_buffers(w, x):
    """qp.mode_buffers over a coalesced stand-in of `w` (the modes take a
    coalesced q4_0 buffer)."""
    qtc = tpk.QuantTensorC("q4_0", w.k, w.r, w.k_padded, w.r_padded,
                           w.k_padded, 512, True, torch.zeros(0), None)
    return qp.mode_buffers(x, qtc, "bf16", 132)


# -- the producer's arithmetic ------------------------------------------------


def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def _scale_rows(p: torch.Tensor, g: int) -> torch.Tensor:
    """A scale or bias plane (f32, or int32 of f16 pairs) -> f32 [Kp, Rp],
    each group's value repeated g times down K."""
    return torch.repeat_interleave(tpk.scale_plane_f32(p), g, dim=-2)


def magic_dequant(w) -> torch.Tensor:
    """The kernel's dequant of every weight of a one-layer QuantTensor, or
    of the planes a coalesced buffer holds, as bf16 [Kp, Rp], from the
    int32 words the kernel reads (csrc/qmatmul_tc.cuh dequant_unit)."""
    coal = isinstance(w, tpk.QuantTensorC)
    fmt = w.fmt
    lo_bits, hi_bits, g = fmt.lo_bits, fmt.hi_bits, fmt.gsize
    if coal:
        lo, hi, _, _ = tpk.coalesced_word_planes(w)
        planes = tpk.uncoalesce_qt(w)
    else:
        lo, hi, planes = w.lo, w.hi, w
    s = _scale_rows(planes.scale, g)
    b = _scale_rows(planes.bias, g) if planes.bias is not None else None
    Kp, Rp = w.k_padded, w.r_padded
    magic = 0x4B000000
    words = lo.to(torch.int64) & 0xFFFFFFFF
    if lo_bits == 8 and not coal:  # int8 plane: byte ^ 0x80 is q + 128
        q = _f32((words & 0xFF) ^ 0x80 | magic) - 8388736.0
        v = q * s
    elif hi_bits == 0:  # field at bit p < 16, else of the word >> 16
        pw = 32 // lo_bits
        signed = fmt.signed_lo or lo_bits == 8
        xor = (1 << (lo_bits - 1)) if signed else 0
        off = xor if xor else fmt.zero
        v = torch.empty((Kp, Rp), dtype=torch.float32)
        for f in range(pw):
            p = lo_bits * f
            pp = p & 15
            src = words if p < 16 else words >> 16
            bits = ((src & (((1 << lo_bits) - 1) << pp)) ^ (xor << pp)) | magic
            q = _f32(bits) - float(8388608 + (off << pp))
            sp = s[f::pw] * 2.0 ** -pp  # exact: a power of two
            v[f::pw] = q * sp
    else:  # q = lo field | hi field << lo_bits
        qlo = tpk.unpack_plane(lo, lo_bits).to(torch.int64)
        qhi = tpk.unpack_plane(hi, hi_bits).to(torch.int64)
        q = _f32(qlo | (qhi << lo_bits) | magic) - float(8388608 + fmt.zero)
        v = q * s
    if b is not None:
        v = v + b
    return v.to(torch.bfloat16)


def _variants(t):
    tq = tpk.pack_ggml(t, random_raw(t, 1024, 256, seed=14), (1024, 256))
    out = [("planes", tq)]
    if tq.scale_packed:
        out.append(("planes_f32", tpk.unpack_scales_qt(tq)))
    for name, w in list(out):
        tk, tr, _ = tqm.coalesce_tiles(w.fmt, w.k_padded, w.r_padded,
                                       w.scale_packed)
        out.append((name.replace("planes", "coalesced"),
                    tpk.coalesce_qt(w, tk, tr)))
    return out


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_magic_dequant_bit_equal_to_plain(t):
    for name, w in _variants(t):
        ref = (tpk.dequant_c(w, trim=False) if name.startswith("coalesced")
               else tpk.dequant(w, trim=False)).bfloat16()
        got = magic_dequant(w)
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16)), \
            name


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q5_1, GgmlType.Q6_K],
                         ids=lambda t: t.name)
def test_magic_dequant_matches_reference(t):
    """The producer's arithmetic against the JAX package's dequant_jnp,
    rounded to bf16 the way its kernel rounds (astype bf16)."""
    raw = random_raw(t, 512, 128, seed=15)
    tq = tpk.pack_ggml(t, raw, (512, 128))
    jq = jpk.pack_ggml(t, raw, (512, 128))
    ref = np.asarray(jpk.dequant_jnp(jq, trim=False).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(magic_dequant(tq).float().numpy(), ref)


def test_operands_read_x_in_place_on_the_swapped_path():
    """x f32, contiguous and 16-byte aligned: the swapped path reads it as
    it is (no copy), the columns past K up to Kp read as zeros; the wide
    path casts to bf16; a misaligned x is copied, zero-padded to Kp."""
    t = GgmlType.Q4_0
    tq = tpk.pack_ggml(t, random_raw(t, 544, 128, seed=16), (544, 128))
    assert tq.k_padded > tq.k
    x = torch.randn(3, 544)
    xk, y, part = tqm.operands(x, tq, tqm.plan(tq, 3))
    assert xk.data_ptr() == x.data_ptr() and xk.shape == (3, 544)
    assert y.shape == (3, 128) and y.dtype == torch.float32
    assert part is not None and part.shape[1:] == (3, 128)
    xk, _, _ = tqm.operands(torch.randn(64, 544), tq, tqm.plan(tq, 64))
    assert xk.dtype == torch.bfloat16 and xk.shape == (64, 544)
    odd = torch.randn(2 * 544 + 1)[1:].view(2, 544)  # 4 bytes off
    xk, _, _ = tqm.operands(odd, tq, tqm.plan(tq, 2))
    assert xk.shape == (2, tq.k_padded)
    assert torch.equal(xk[:, :544], odd) and bool((xk[:, 544:] == 0).all())


# -- the compiler's report (its nvcc runs on the card's machine only) -------


def test_kernel_report_reads_ptxas_output():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function 'dq_q4_0_planes' for 'sm_90a'
ptxas info    : Function properties for dq_q4_0_planes
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 47104 bytes smem
ptxas info    : Compiling entry function 'sum_splits' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers"""
    assert kernel_report.ptxas_table(text) == [
        {"kernel": "dq_q4_0_planes", "spill_stores": 8, "spill_loads": 4,
         "registers": 64, "smem_bytes": 47104},
        {"kernel": "sum_splits", "spill_stores": 0, "spill_loads": 0,
         "registers": 12, "smem_bytes": 0}]


def test_kernel_report_counts_the_main_loop():
    """The longest backward branch holding a barrier is the main loop; a
    shorter loop without one (a fill loop) and the forward branches are
    not."""
    text = """\t\tFunction : _ZN2tc4testEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/              @!P0 BRA 0x10 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   LOP3.LUT R4, R2, 0xf, R5, 0x6a, !PT ;
        /*0050*/                   FADD R4, R4, -8388616 ;
        /*0060*/               @P1 BRA 0x80 ;
        /*0070*/                   HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        /*0080*/              @!P2 BRA 0x30 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;"""
    funcs = kernel_report.sass_listing(text)
    ins = funcs["_ZN2tc4testEv"]
    assert [op for _, op, _ in ins][:3] == ["MOV", "LDS", "BRA"]
    assert ins[2] == (0x20, "BRA", 0x10)
    assert kernel_report.main_loop(ins) == {"BAR": 1, "LOP3": 1, "FADD": 1,
                                            "BRA": 2, "HMMA": 1}
    layouts = ("planes", "coalesced")
    assert set(kernel_report.LOOP_KERNELS) == {
        *(f"{p}_{lay}" for p in ("swapped8", "swapped16", "wide_mi1",
                                 "wide_mi2") for lay in layouts),
        *(f"{c}_swapped8_{lay}" for c in ("stream", "unpack", "dequant")
          for lay in layouts),
        *(f"{c}_wide_mi2_planes" for c in ("stream", "unpack", "dequant")),
        *(f"mode_{m}" for m in qp.MODES)}
    # one kernel a name: the production ones in the production library
    pieces = [piece for _, piece in kernel_report.LOOP_KERNELS.values()]
    assert len(set(pieces)) == len(pieces) - 1  # mode_base is K1's code
    assert {lib for name, (lib, _) in kernel_report.LOOP_KERNELS.items()
            if name.startswith(("swapped", "wide"))} == {"qmatmul"}


def test_kernel_report_main_loops_count_a_pass():
    """A loop the compiler unrolled twice holds two passes (four barriers
    on the swapped path): its counts are halved; a kernel no name matches
    once is reported as an error."""
    body = [(0x10, "LDS", None), (0x20, "BAR", None), (0x30, "HMMA", None),
            (0x40, "BAR", None)]
    twice = body + [(a + 0x40, o, t) for a, o, t in body] + \
        [(0x90, "BRA", 0x10)]
    piece = kernel_report.LOOP_KERNELS["swapped8_planes"][1]
    wide = kernel_report.LOOP_KERNELS["wide_mi2_planes"][1]
    sass = {"qmatmul": {f"void {piece}(args)": twice,
                        f"void {wide}(args)": twice},
            "qmatmul_probe": {}}
    got = kernel_report.main_loops(sass)
    assert got["swapped8_planes"]["passes_in_body"] == 2
    assert got["swapped8_planes"]["instructions"] == 4.5
    assert got["swapped8_planes"]["by_opcode"] == {
        "LDS": 1, "BAR": 2, "HMMA": 1, "BRA": 0.5}
    assert got["wide_mi2_planes"]["passes_in_body"] == 4
    assert "error" in got["mode_bf16"] and "error" in got["swapped8_coalesced"]


def test_kernel_report_tensor_core_ops():
    """The wide path's kernels must hold HGMMA and no HMMA, the attention
    GQA branch HMMA; registers and spills beside them."""
    sass = {"tc::qmm_wgmma<A>": [(0, "HGMMA", None), (16, "HGMMA", None),
                                 (32, "SYNCS", None)],
            "tc::qmm_wgmma<B>": [(0, "HMMA", None), (16, "HGMMA", None)],
            "tc::qmm_swapped<A>": [(0, "HMMA", None)]}
    ptxas = [{"kernel": "tc::qmm_wgmma<A>", "registers": 90,
              "spill_stores": 0, "spill_loads": 0},
             {"kernel": "tc::qmm_wgmma<B>", "registers": 96,
              "spill_stores": 4, "spill_loads": 8}]
    got = kernel_report.tensor_core_ops(sass, ptxas, "tc::qmm_wgmma<",
                                        "HGMMA", "HMMA")
    assert [(r["HGMMA"], r["HMMA"]) for r in got["kernels"]] == [(2, 0),
                                                                  (1, 1)]
    assert not got["ok"] and got["max_registers"] == 96
    assert got["spills"] == 12
    del sass["tc::qmm_wgmma<B>"]
    assert kernel_report.tensor_core_ops(sass, ptxas, "tc::qmm_wgmma<",
                                         "HGMMA", "HMMA")["ok"]
    assert set(kernel_report.TC_KERNELS) == {"qmm_wgmma", "gqa_mma"}


def test_kernel_report_source_has_both_kernels_of_every_case(tmp_path):
    src = kernel_report.dequant_source(tmp_path).read_text()
    assert src.count("{") == src.count("}")
    for f, lay in kernel_report.CASES:
        for kind in ("dq", "base"):
            assert f" {kind}_{f}_{lay}(" in src
        coal = "true" if lay == "coalesced" else "false"
        assert (f"body<Fmt<{kernel_report.SASS_FORMATS[f]}>, {coal}, true>"
                in src)


def test_sync_costs_probe_source_and_parser():
    """The probe of the wide path's synchronisation steps: one mode of its
    CUDA source a step, and its output read back by step, an error
    raised."""
    from llm_tpu_torch.probes import sync_costs

    src = sync_costs._SRC
    assert src.count("{") == src.count("}")
    assert len(sync_costs.STEPS) == 7 and "mode == 5" in src
    got = sync_costs.parse("0 208.1 0\nnoise\n3 338.5 0\n6 1615.5 0\n")
    assert got == {"syncthreads": 208.1,
                   "cp_async_arrive_noinc_try_wait": 338.5,
                   "cp_async_global_wait_syncthreads": 1615.5}
    with pytest.raises(RuntimeError):
        sync_costs.parse("2 10.0 700\n")
