"""The decode-attention kernel's host side and arithmetic on the CPU
(llm_tpu_torch/csrc/paged_attention.cu, the port of the TPU kernels K4 and
K2), where the kernel itself cannot run:

(a) `launch_plan` is legal at every shape `chip_smoke.py` launches and at
    the repo's geometries: the chunks cover [0, W) once, the shared memory
    fits a block, the vector width divides the row bytes, and a chunk never
    reaches a page it did not look up.
(b) A plain-torch walk of the plan, as the kernel computes it (per-chunk
    partials with the k scale on the score and the v scale on the
    probability, chunks at or past n_past skipped, the merge in chunk
    order), held against `_paged_attention_call` in Pallas interpret mode
    and against the port's plain versions. Tolerance rtol = atol = 1e-5
    (relative to max|acc| for acc), as tests/test_torch_paged_attention.py:
    f32 on both sides, the sums in another order. n_past = 0 gives exactly
    m = -1e30, l = 0, acc = 0.
(c) The kernel's register decode written as torch integer ops (bias, PRMT
    of a byte into the mantissa of 2^23, subtract) is bit-equal to the
    plain conversions for every byte value (int8, int4) and every bf16.
(d) The tensor-core branch (gqa_mma): `launch_plan` takes it exactly where
    the heads do not fit registers (`pipe` False) on a bf16, int8 or int4
    pool from rep 5, with a legal layout; the three-term bf16 split of q and P is
    exact; and a plain walk of the branch (the split, tiles in order, the
    chunks of 16 keys round robin over the warps along the keys, each warp
    its own online softmax over three-term products summed in f32, the
    warps merged in order, then the splits) is held against
    `_paged_attention_call` in interpret mode and the plain versions, to
    the rule of (b).
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from llm_tpu.ops.layers import alibi_slopes as j_alibi_slopes
from llm_tpu.ops.paged_attention import _paged_attention_call
from llm_tpu_torch.ops import dense_attention as tda
from llm_tpu_torch.ops import paged_attention as tpa
from llm_tpu_torch.ops.packing import unpack_int4_rows

SMS = 132  # the H100's SMs
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
          "int4": torch.uint8}
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (a) the plan


def _row_bytes(D, kv):
    return D // 2 if kv == "int4" else D * DTYPES[kv].itemsize


def assert_legal(B, Hkv, rep, D, page, W, kv):
    plan = tpa.launch_plan(B, Hkv, rep, D, page, W, DTYPES[kv], SMS)
    span, splits = plan.tile * plan.tps, plan.grid[1]
    groups = tpa.mma_warps(rep)[1] if plan.mma else 1
    assert plan.grid == (B * Hkv * groups, math.ceil(W / span))
    # the splits [s * span, min((s + 1) * span, W)) cover [0, W) once
    assert plan.tile >= 1 and (splits - 1) * span < W <= splits * span
    # the tensor-core branch exactly where the heads do not fit registers,
    # from rep 5
    assert plan.mma == (not plan.pipe and kv != "f32"
                        and rep >= tpa.MMA_MIN_REP)
    assert plan.tps == 1 or plan.mma or (plan.pipe and plan.heads >= rep)
    assert plan.smem.total <= tpa.SMEM_BLOCK_MAX
    rb = _row_bytes(D, kv)
    if plan.mma:
        assert_mma_layout(plan, rb, rep, D, page, W, kv)
    else:
        assert plan.warps_m == 0
        assert_layout(plan, rb, rep, D, page, W, kv)
    assert plan.vec in (4, 8, 16) and rb % plan.vec == 0
    vpr = rb // plan.vec
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.lanes * plan.nv >= vpr > plan.lanes * (plan.nv - 1)
    assert plan.nv <= (2 if kv == "f32" else 1)
    elems = plan.nv * (2 * plan.vec if kv == "int4"
                       else plan.vec // DTYPES[kv].itemsize)
    assert plan.heads in (1, 2, 4, 8)
    assert plan.heads == 1 or plan.heads * elems <= tpa.REG_FLOATS
    if plan.pipe:  # q and acc of every head in registers
        assert rep <= plan.heads < 2 * rep
        assert plan.heads * elems <= tpa.REG_FLOATS // 2
    else:
        assert plan.heads * elems > tpa.REG_FLOATS // 2 or plan.heads < rep
    # a tile divides the page size or is a multiple of it, unless the
    # window lies in one page; every position of a split lies on a page it
    # looked up
    assert W <= page or page % plan.tile == 0 or plan.tile % page == 0
    room = (plan.smem.merge - plan.smem.pages) // 8  # page rows it holds
    for sp in range(splits):
        p0 = sp * span
        touched = {p // page for p in range(p0, min(p0 + span, W))}
        assert touched <= set(range(p0 // page, p0 // page + room))
    return plan


def assert_layout(plan, rb, rep, D, page, W, kv):
    """The shared-memory regions the kernel addresses: in order, on 16
    bytes, each large enough for what the kernel puts there."""
    L, stages = plan.smem, 2 if plan.tps > 1 else 1
    starts = [0, L.v, L.ks, L.vs, L.q, L.p, L.stats, L.pages, L.merge,
              L.flag, L.total]
    assert all(x % 16 == 0 for x in starts + [L.kst, L.vst, L.sst])
    assert starts == sorted(starts)
    tile, heads = plan.tile, min(rep, plan.heads)
    # K of stage 0 also holds the cross-warp sum of acc [warps, heads, D]
    assert L.kst >= max(tile * rb, tpa.WARPS * heads * D * 4)
    assert L.vst >= tile * rb and L.v == L.kst + (stages - 1) * L.vst
    assert L.ks - L.v == stages * L.vst
    quantized = kv in ("int8", "int4")
    assert L.sst == (-(-tile * 4 // 16) * 16 if quantized else 0)
    assert L.vs - L.ks == L.q - L.vs == stages * L.sst
    assert L.p - L.q >= rep * D * 4 and L.stats - L.p >= rep * tile * 4
    assert L.pages - L.stats >= rep * 3 * 4
    span, splits = tile * plan.tps, plan.grid[1]
    assert L.merge - L.pages >= tpa.span_pages(span, page) * 8
    assert L.flag - L.merge >= (splits * rep * 8 if splits > 1 else 0)
    assert L.total - L.flag == 16


def assert_mma_layout(plan, rb, rep, D, page, W, kv):
    """gqa_mma's regions: in order, on 16 bytes, each large enough; the
    warps' partials on the stages only where no head group follows."""
    L, stages = plan.smem, 2 if plan.tps > 1 else 1
    assert isinstance(L, tpa.MmaSmem)
    t16, es = -(-plan.tile // 16) * 16, D + 8
    quantized = kv != "bf16"
    assert L.kst >= t16 * (rb if quantized else 2 * es) and L.vst == L.kst
    assert L.v == stages * L.kst and L.ks == L.v + stages * L.vst
    assert L.sst == (-(-t16 * 4 // 16) * 16 if quantized else 0)
    assert L.vs - L.ks == L.q - L.vs == stages * L.sst
    mt = -(-rep // 16)
    warps_m, groups = tpa.mma_warps(rep)
    rows = warps_m * 16  # the heads a block holds
    assert L.cvt - L.q >= 3 * min(rows, mt * 16) * es * 2
    red = tpa.WARPS * 16 * (D + 4) * 4
    assert plan.warps_m == warps_m in (1, 2, 4)
    # the groups' blocks cover the heads; a group short of a block only
    # where it is the only one
    assert rows * groups >= rep and (groups == 1 or rows * (groups - 1) < rep)
    # the warps' partials overlay the stages, q and the decoded tiles
    assert L.pages - L.cvt >= (2 * t16 * es * 2 if quantized else 0)
    assert L.pages >= red
    starts = [0, L.v, L.ks, L.vs, L.q, L.cvt, L.pages, L.merge, L.flag,
              L.total]
    assert all(x % 16 == 0 for x in starts + [L.kst, L.vst, L.sst])
    assert starts == sorted(starts)
    span, splits = plan.tile * plan.tps, plan.grid[1]
    assert L.merge - L.pages >= tpa.span_pages(span, page) * 8
    assert L.flag - L.merge >= (splits * min(rows, rep) * 8 if splits > 1
                                else 0)
    assert L.total - L.flag == 16


@pytest.mark.parametrize("case", chip_smoke.PAGED_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-rep{c[6]}")
def test_plan_legal_chip_paged_cases(case):
    name, kv, page, B, (kind, top), hkv, rep, alibi = case
    W = -(-top // page) * page  # the window the largest stream needs
    plan = assert_legal(B, hkv, rep, chip_smoke.D, page, W, kv)
    # the 7B shapes: whole rows in 16-byte loads, 4 blocks an SM, a tile
    # loop with every head's q and acc in registers at rep <= 4 (bf16),
    # <= 2 (int8), 1 (int4, f32 at rep 1); from rep 5 the tensor-core
    # branch with 2 blocks an SM
    assert plan.vec == 16 and plan.smem.total <= (
        tpa.MMA_RESIDENT if plan.mma else tpa.SMEM_RESIDENT)
    fits = {"bf16": 4, "int8": 2, "int4": 1, "f32": 1}[kv]
    assert plan.pipe == (rep <= fits) and plan.mma == (rep > 4)


@pytest.mark.parametrize("case", chip_smoke.DENSE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-W{c[2]}")
def test_plan_legal_chip_dense_cases(case):
    name, kv, W, n_past, hkv, rep, alibi, timed = case
    plan = assert_legal(len(n_past), hkv, rep, chip_smoke.D, chip_smoke.CTX,
                        W, kv)
    assert plan.vec == 16 and plan.pipe
    assert plan.smem.total <= tpa.SMEM_RESIDENT


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("page", [16, 24, 128, 256, "S"])
@pytest.mark.parametrize("rep", [1, 4, 8, 16, 71])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_plan_legal_geometries(D, rep, page, kv):
    for B, Hkv, W in ((1, 32, 512), (1, 1, 2048), (16, 8, 1100),
                      (64, 32, 256), (3, 2, 24), (2, 4, 7)):
        pg = W if page == "S" else page  # the dense cache: one page
        assert_legal(B, Hkv, rep, D, pg, -(-W // pg) * pg, kv)


# ---------------------------------------------------------------------------
# (b) the plan's walk, as the kernel computes it


def walk(plan, kq_scale, k, v, ks, vs, tables, n_past, slopes, W, q):
    """One layer of the pool (k/v [NP, Hkv, page, Dp], scales [NP, Hkv,
    page] or None, tables [B, P] or None) and q [B, Hkv, rep, D] -> (m, l
    [B, Hkv, rep], acc [B, Hkv, rep, D]), block by block as the kernel: a
    split's tiles fold into a running online softmax (the k scale on the
    score, the v scale on the probability), then the splits merge in
    order."""
    B, Hkv, rep, D = q.shape
    NP, _, page, _ = k.shape
    tile, span = plan.tile, plan.tile * plan.tps
    m = torch.full((B, Hkv, rep), tpa.NEG_INF)
    l = torch.zeros((B, Hkv, rep))
    acc = torch.zeros((B, Hkv, rep, D))
    for b in range(B):
        valid = min(int(n_past[b]), W)
        parts = []
        for sp in range(-(-valid // span)):  # the active splits
            pm = torch.full((Hkv, rep), tpa.NEG_INF)
            pl = torch.zeros((Hkv, rep))
            pa = torch.zeros((Hkv, rep, D))
            for p0 in range(sp * span, min((sp + 1) * span, valid), tile):
                pos = torch.arange(p0, min(p0 + tile, valid))
                j = pos // page
                if tables is None:
                    phys = torch.full_like(j, b)
                else:
                    phys = tables[b, j.clamp(max=tables.shape[1] - 1)].long()
                phys, o = phys.clamp(0, NP - 1), pos - j * page
                kf = tpa._rows_f32(k[phys, :, o]).transpose(0, 1)
                vf = tpa._rows_f32(v[phys, :, o]).transpose(0, 1)
                s = torch.einsum("hrd,hnd->hrn", q[b], kf) * kq_scale
                if ks is not None:
                    s = s * ks[phys, :, o].T[:, None, :]
                if slopes is not None:
                    s = s + slopes[:, :, None] * pos.to(torch.float32)
                mx = torch.maximum(pm, s.amax(dim=-1))
                e = torch.exp(s - mx[..., None])
                corr = torch.exp(pm - mx)
                pl = pl * corr + e.sum(dim=-1)
                pr = e if vs is None else e * vs[phys, :, o].T[:, None, :]
                pa = pa * corr[..., None] + torch.einsum("hrn,hnd->hrd", pr,
                                                         vf)
                pm = mx
            parts.append((pm, pl, pa))
        if len(parts) == 1:
            m[b], l[b], acc[b] = parts[0]
        elif parts:  # the last ticket's merge, in split order
            mx = parts[0][0]
            for pm, _, _ in parts[1:]:
                mx = torch.maximum(mx, pm)
            ls, a = torch.zeros_like(mx), torch.zeros_like(acc[b])
            for pm, pl, pa in parts:
                f = torch.exp(pm - mx)
                ls = ls + pl * f
                a = a + pa * f[..., None]
            m[b], l[b], acc[b] = mx, ls, a
    return m, l, acc


L_, NP_, D_, B_ = 2, 14, 128, 4


def make_pool(kv, hkv, page, P, seed):
    """A shuffled pool and tables: stream 0 empty, 1 mid-page, 2 a full
    window, 3 one position; columns past a stream's pages point at the
    trash page 0."""
    rng = np.random.default_rng(seed)
    shape = (L_, NP_, hkv, page, D_)
    if kv in ("int8", "int4"):
        lo, hi, dt = (-127, 128, np.int8) if kv == "int8" else (0, 256,
                                                                 np.uint8)
        cshape = shape if kv == "int8" else shape[:-1] + (D_ // 2,)
        k = rng.integers(lo, hi, size=cshape).astype(dt)
        v = rng.integers(lo, hi, size=cshape).astype(dt)
        ks = rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    perm = rng.permutation(np.arange(1, NP_))
    tables = np.zeros((B_, P), np.int32)
    tables[1, :2] = perm[:2]
    tables[2, :P] = perm[2:2 + P]
    tables[3, 0] = perm[2 + P]
    return k, v, ks, vs, tables


def as_torch(a, kv):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if kv == "bf16" and t.is_floating_point() \
        else t


def as_jax(a, kv):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16) if kv == "bf16" and \
        a.dtype == np.float32 else jnp.asarray(a)


def close(got, ref):
    m, l, acc = (np.asarray(x, np.float32) for x in got)
    jm, jl, jacc = (np.asarray(x, np.float32) for x in ref)
    assert m.shape == jm.shape and acc.shape == jacc.shape
    np.testing.assert_allclose(m, jm, **TOL)
    np.testing.assert_allclose(l, jl, **TOL)
    scale = float(np.abs(jacc).max())
    np.testing.assert_allclose(acc, jacc, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("hkv,rep,alibi", [(2, 1, False), (2, 4, True)],
                         ids=["mha", "gqa-alibi"])
def test_walk_matches_k4_interpret_and_plain(kv, hkv, rep, alibi):
    page, P = 16, 4
    wp = P
    W = wp * page
    k, v, ks, vs, tables = make_pool(kv, hkv, page, P, seed=rep + 3)
    n_past = np.array([0, 23, W, 1], np.int32)  # empty, mid-page, full, one
    q = np.random.default_rng(9).standard_normal(
        (B_, 1, hkv, rep, D_)).astype(np.float32)
    slopes = (np.array(j_alibi_slopes(hkv * rep, 8.0)).reshape(hkv, rep)
              if alibi else None)
    kq = 1.0 / np.sqrt(D_)
    layer = 1
    tk, tv, tks, tvs = (as_torch(a, kv) for a in (k, v, ks, vs))
    tsl = None if slopes is None else torch.from_numpy(slopes)
    qt = torch.from_numpy(q)
    ref = _paged_attention_call(
        as_jax(k, kv), as_jax(v, kv), as_jax(ks, kv), as_jax(vs, kv),
        jnp.asarray(tables), jnp.asarray(n_past),
        None if slopes is None else jnp.asarray(slopes), jnp.int32(layer),
        jnp.asarray(q[:, 0]), window_pages=wp, kq_scale=float(kq),
        interpret=True, hkv=hkv, rep=rep, d=D_)
    plain = tpa.paged_attention_plain(
        SimpleNamespace(kq_scale=kq), tk, tv, tks, tvs,
        torch.from_numpy(tables), torch.from_numpy(n_past), tsl, wp, layer,
        qt)
    # a grid short of the card (a split a tile, merged by the last ticket)
    # and a card of one SM (one split, its tiles folded in turn)
    for sms in (10**4, 1):
        plan = tpa.launch_plan(B_, hkv, rep, D_, page, W, DTYPES[kv], sms)
        got = walk(plan, kq, tk[layer], tv[layer],
                   None if tks is None else tks[layer],
                   None if tvs is None else tvs[layer],
                   torch.from_numpy(tables), n_past, tsl, W, qt[:, 0])
        close(got, ref)
        close(got, [x[:, 0] for x in plain])
    m, l, acc = got  # stream 0: the exact constants
    assert (m[0] == tpa.NEG_INF).all()
    assert (l[0] == 0).all() and (acc[0] == 0).all()


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("page", [24, 8])
def test_walk_page_not_power_of_two(kv, page):
    """Tiles that are several pages (page 8) or a multiple or divisor of a
    page that divides no power of two (24), against the plain page loop."""
    hkv, rep, P = 2, 2, 8
    W = P * page
    k, v, ks, vs, tables = make_pool(kv, hkv, page, P, seed=page)
    n_past = np.array([0, page + 5, W, 1], np.int32)
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B_, 1, hkv, rep, D_)).astype(np.float32))
    tk, tv, tks, tvs = (as_torch(a, kv) for a in (k, v, ks, vs))
    for sms in (10**4, 1):  # one tile a split; one split, tiles in turn
        plan = tpa.launch_plan(B_, hkv, rep, D_, page, W, DTYPES[kv], sms)
        assert page % plan.tile == 0 or plan.tile % page == 0
        one_split = (plan.pipe or plan.mma) and sms == 1
        assert plan.grid[1] == (1 if one_split else math.ceil(W / plan.tile))
        got = walk(plan, 0.1, tk[0], tv[0], None if tks is None else tks[0],
                   None if tvs is None else tvs[0], torch.from_numpy(tables),
                   n_past, None, W, q[:, 0])
        plain = tpa.paged_attention_plain(
            SimpleNamespace(kq_scale=0.1), tk, tv, tks, tvs,
            torch.from_numpy(tables), torch.from_numpy(n_past), None, P, 0,
            q)
        close(got, [x[:, 0] for x in plain])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_walk_dense_cache_matches_plain(kv):
    """The dense cache [B, Hkv, S, D]: one page of S positions a stream,
    no table."""
    Lc, B, hkv, S, D, W, rep = 2, 3, 2, 96, 64, 80, 2
    rng = np.random.default_rng(4)
    shape = (Lc, B, hkv, S, D)
    if kv == "int8":
        ck = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        cv = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.001, 0.02, shape[:-1]).astype(
            np.float32))
        vs = torch.from_numpy(rng.uniform(0.001, 0.02, shape[:-1]).astype(
            np.float32))
    else:
        ck = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()
        cv = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()
        ks = vs = None
    q = torch.from_numpy(rng.standard_normal((B, 1, hkv, rep, D)).astype(
        np.float32))
    n_past = torch.tensor([0, 37, W])
    plan = tpa.launch_plan(B, hkv, rep, D, S, W, ck.dtype, 1)
    got = walk(plan, 0.125, ck[1], cv[1], None if ks is None else ks[1],
               None if vs is None else vs[1], None, n_past, None, W, q[:, 0])
    ref = tda.dense_attention_plain(SimpleNamespace(kq_scale=0.125), ck, cv,
                                    ks, vs, n_past, W, 1, q)
    close(got, [x[:, 0] for x in ref])


# ---------------------------------------------------------------------------
# (c) the register decode


def _words(byte_values: np.ndarray) -> torch.Tensor:
    """Little-endian 32-bit words of a byte array, as int64."""
    return torch.from_numpy(byte_values.astype(np.uint8).view(
        np.uint32).astype(np.int64))


def _magic(x: torch.Tensor, i: int, bias: float) -> torch.Tensor:
    """PRMT of byte i of x into 0x4B000000 (2^23 + the byte), as f32 bits,
    minus 2^23 + bias."""
    bits = ((x >> (8 * i)) & 0xFF) | 0x4B000000
    return bits.to(torch.int32).view(torch.float32) - (8388608.0 + bias)


def test_int8_decode_bit_equal():
    codes = np.arange(-128, 128, dtype=np.int8)
    u = _words(codes.view(np.uint8)) ^ 0x80808080
    got = torch.stack([_magic(u, i, 128.0) for i in range(4)], dim=1)
    ref = torch.from_numpy(codes).to(torch.float32)
    assert torch.equal(got.reshape(-1).view(torch.int32),
                       ref.view(torch.int32))


def test_int4_decode_bit_equal():
    row = np.arange(256, dtype=np.uint8)  # every byte: D = 512
    w = _words(row)
    lo = (w & 0x0F0F0F0F) ^ 0x08080808
    hi = ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
    got = torch.cat([
        torch.stack([_magic(lo, i, 8.0) for i in range(4)], 1).reshape(-1),
        torch.stack([_magic(hi, i, 8.0) for i in range(4)], 1).reshape(-1)])
    ref = unpack_int4_rows(torch.from_numpy(row))
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_bf16_decode_bit_equal():
    bits = np.arange(1 << 16, dtype=np.uint16)
    w = _words(bits.view(np.uint8))
    as_f32 = [((w << 16) & 0xFFFFFFFF), w & 0xFFFF0000]
    got = torch.stack([(x - ((x >> 31) << 32)).to(torch.int32)
                       for x in as_f32], 1).reshape(-1)
    ref = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).to(
        torch.float32)
    assert torch.equal(got, ref.view(torch.int32))


# ---------------------------------------------------------------------------
# (d) the tensor-core branch


@pytest.mark.parametrize("kv", list(DTYPES))
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_mma_branch_exactly_where_pipe_is_false(D, kv):
    """Every rep from 1 to 80 at Falcon's, GQA's and the serving shapes:
    the tensor-core branch where q and acc of every head do not fit a
    lane's registers, from rep 5, on every pool but f32; below rep 5 the
    heads do fit on bf16 pools, and int8 and int4 pools keep the
    CUDA-core branch."""
    assert tpa.MMA_MIN_REP == 5
    for rep in range(1, 81):
        for B, Hkv, page, W in ((1, 1, 2048, 512), (16, 8, 128, 1152),
                                (3, 2, 24, 96)):
            plan = tpa.launch_plan(B, Hkv, rep, D, page, W, DTYPES[kv], SMS)
            assert plan.mma == (not plan.pipe and kv != "f32"
                                and rep >= 5), (rep, plan)
            if kv == "bf16" and rep < 5:
                assert plan.pipe


def bf16_terms(x: torch.Tensor):
    """The kernel's split of f32 values into three bf16 terms (split3)."""
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def test_three_term_split_is_exact():
    """Exact down to |x| = 2^-100 (the last term still a normal bf16);
    below, off by less than bf16's smallest subnormal."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(1 << 16), rng.uniform(0, 1, 1 << 16),
        np.exp(rng.uniform(-69, 80, 1 << 16))]).astype(np.float32))
    hi, mid, lo = bf16_terms(x)
    assert torch.equal(hi + mid + lo, x)
    for t in (hi, mid, lo):  # each term is a bf16 value
        assert torch.equal(t.bfloat16().float(), t)
    tiny = torch.from_numpy(np.exp(rng.uniform(-87, -69, 1 << 16)).astype(
        np.float32))
    assert float((sum(bf16_terms(tiny)) - tiny).abs().max()) < 2.0**-133


def walk_mma(plan, kq_scale, k, v, ks, vs, tables, n_past, slopes, W, q):
    """`walk` of the tensor-core branch: within a split, the chunks of 16
    keys of each tile go round robin over the warps along the keys, each
    warp folding its chunks into its own online softmax (scores of the
    three bf16 terms of q, P's three terms against V, summed in f32); the
    warps merge in order, then the splits in order."""
    B, Hkv, rep, D = q.shape
    NP, _, page, _ = k.shape
    wk_n = tpa.WARPS // plan.warps_m
    tile, span = plan.tile, plan.tile * plan.tps
    m = torch.full((B, Hkv, rep), tpa.NEG_INF)
    l = torch.zeros((B, Hkv, rep))
    acc = torch.zeros((B, Hkv, rep, D))
    for b in range(B):
        valid = min(int(n_past[b]), W)
        qt = bf16_terms(q[b])  # [Hkv, rep, D] each
        parts = []
        for sp in range(-(-valid // span)):
            warps = [[torch.full((Hkv, rep), tpa.NEG_INF),
                      torch.zeros((Hkv, rep)), torch.zeros((Hkv, rep, D))]
                     for _ in range(wk_n)]
            for p0 in range(sp * span, min((sp + 1) * span, valid), tile):
                n = min(tile, valid - p0)
                for c in range(-(-n // 16)):
                    wm_, wl, wa = warps[c % wk_n]
                    pos = torch.arange(p0 + 16 * c, p0 + min(16 * c + 16, n))
                    j = pos // page
                    if tables is None:
                        phys = torch.full_like(j, b)
                    else:
                        phys = tables[b, j.clamp(max=tables.shape[1] - 1)]
                    phys, o = phys.long().clamp(0, NP - 1), pos - j * page
                    kf = tpa._rows_f32(k[phys, :, o]).transpose(0, 1)
                    vf = tpa._rows_f32(v[phys, :, o]).transpose(0, 1)
                    s = sum(torch.einsum("hrd,hnd->hrn", t, kf) for t in qt)
                    s = s * kq_scale
                    if ks is not None:
                        s = s * ks[phys, :, o].T[:, None, :]
                    if slopes is not None:
                        s = s + slopes[:, :, None] * pos.to(torch.float32)
                    mx = torch.maximum(wm_, s.amax(dim=-1))
                    e = torch.exp(s - mx[..., None])
                    corr = torch.exp(wm_ - mx)
                    wl = wl * corr + e.sum(dim=-1)
                    pr = e if vs is None else e * vs[phys, :, o].T[:, None, :]
                    wa = wa * corr[..., None] + sum(
                        torch.einsum("hrn,hnd->hrd", t, vf)
                        for t in bf16_terms(pr))
                    warps[c % wk_n] = [mx, wl, wa]
            mx = warps[0][0]
            for w in warps[1:]:
                mx = torch.maximum(mx, w[0])
            ls, a = torch.zeros_like(mx), torch.zeros((Hkv, rep, D))
            for wm_, wl, wa in warps:  # the block's merge, in warp order
                f = torch.exp(wm_ - mx)
                ls = ls + wl * f
                a = a + wa * f[..., None]
            parts.append((mx, ls, a))
        if len(parts) == 1:
            m[b], l[b], acc[b] = parts[0]
        elif parts:
            mx = parts[0][0]
            for pm, _, _ in parts[1:]:
                mx = torch.maximum(mx, pm)
            ls, a = torch.zeros_like(mx), torch.zeros_like(acc[b])
            for pm, pl, pa in parts:
                f = torch.exp(pm - mx)
                ls = ls + pl * f
                a = a + pa * f[..., None]
            m[b], l[b], acc[b] = mx, ls, a
    return m, l, acc


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("hkv,rep,alibi", [(2, 8, True), (1, 71, False)],
                         ids=["gqa8-alibi", "falcon71"])
def test_mma_walk_matches_k4_interpret_and_plain(kv, hkv, rep, alibi):
    """rep 8 (one m-tile, the keys over 4 warps) and rep 71 at D 128 (5
    m-tiles: a block of 4 warps along the heads, and a second head group's
    block)."""
    page, P = 16, 4
    W = P * page
    k, v, ks, vs, tables = make_pool(kv, hkv, page, P, seed=rep)
    n_past = np.array([0, 23, W, 1], np.int32)
    q = np.random.default_rng(rep + 1).standard_normal(
        (B_, 1, hkv, rep, D_)).astype(np.float32)
    slopes = (np.array(j_alibi_slopes(hkv * rep, 8.0)).reshape(hkv, rep)
              if alibi else None)
    kq, layer = 1.0 / np.sqrt(D_), 1
    tk, tv, tks, tvs = (as_torch(a, kv) for a in (k, v, ks, vs))
    tsl = None if slopes is None else torch.from_numpy(slopes)
    qt = torch.from_numpy(q)
    ref = _paged_attention_call(
        as_jax(k, kv), as_jax(v, kv), as_jax(ks, kv), as_jax(vs, kv),
        jnp.asarray(tables), jnp.asarray(n_past),
        None if slopes is None else jnp.asarray(slopes), jnp.int32(layer),
        jnp.asarray(q[:, 0]), window_pages=P, kq_scale=float(kq),
        interpret=True, hkv=hkv, rep=rep, d=D_)
    plain = tpa.paged_attention_plain(
        SimpleNamespace(kq_scale=kq), tk, tv, tks, tvs,
        torch.from_numpy(tables), torch.from_numpy(n_past), tsl, P, layer,
        qt)
    for sms in (10**4, 1):
        plan = tpa.launch_plan(B_, hkv, rep, D_, page, W, DTYPES[kv], sms)
        assert plan.mma
        got = walk_mma(plan, kq, tk[layer], tv[layer],
                       None if tks is None else tks[layer],
                       None if tvs is None else tvs[layer],
                       torch.from_numpy(tables), n_past, tsl, W, qt[:, 0])
        close(got, ref)
        close(got, [x[:, 0] for x in plain])
        m, l, acc = got  # stream 0: the exact constants
        assert (m[0] == tpa.NEG_INF).all()
        assert (l[0] == 0).all() and (acc[0] == 0).all()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mma_walk_dense_falcon_shape(kv):
    """Falcon-7B's decode: one kv head of 71 query heads at D 64 over the
    dense cache (one page of S positions a stream), several tiles a split
    on a card of one SM, against the plain dense pass."""
    Lc, B, hkv, S, D, W, rep = 2, 2, 1, 160, 64, 150, 71
    rng = np.random.default_rng(11)
    shape = (Lc, B, hkv, S, D)
    if kv == "int8":
        ck, cv = (torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.02, shape[:-1])
                                   .astype(np.float32)) for _ in range(2))
    else:
        ck, cv = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16() for _ in range(2))
        ks = vs = None
    q = torch.from_numpy(rng.standard_normal((B, 1, hkv, rep, D)).astype(
        np.float32))
    n_past = torch.tensor([W, 37])
    ref = tda.dense_attention_plain(SimpleNamespace(kq_scale=0.125), ck, cv,
                                    ks, vs, n_past, W, 1, q)
    for sms in (10**4, 1):
        plan = tpa.launch_plan(B, hkv, rep, D, S, W, ck.dtype, sms)
        assert plan.mma and plan.warps_m == 4
        got = walk_mma(plan, 0.125, ck[1], cv[1],
                       None if ks is None else ks[1],
                       None if vs is None else vs[1], None, n_past, None, W,
                       q[:, 0])
        close(got, [x[:, 0] for x in ref])
