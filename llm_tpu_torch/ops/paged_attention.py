"""Decode attention over the paged KV pool, read through page tables.

The counterpart of `llm_tpu/ops/paged_attention.py`. `paged_attention_pass`
is the `online_pass` hook of `models/forward._attention_batched` for paged
caches: it turns the query of one new token per stream into online-softmax
partials (m, l, acc) over the logical positions below `window_pages * page`
of one layer, each position read from the physical page that the stream's
table names, and the caller merges them with the token's own key. On a CUDA
tensor it launches the hand-written kernel `csrc/paged_attention.cu` (the
port of the TPU kernel K4) once, with the geometry `launch_plan` gives and
scratch that persists per device and stream; on a CPU tensor it runs
`paged_attention_plain`,
the loop over logical pages that prefill chunks (T > 1) also take. The
same kernel serves the dense cache's decode attention
(`ops/dense_attention.py`): one layer of that cache is a pool with one page
of S positions a stream.

Pool layout, as the reference's: K/V [L, NP, Hkv, page, D] in bf16, f32 or
int8 codes, or uint8 [L, NP, Hkv, page, D/2] of planar int4 codes; int8 and
int4 pools carry f32 scales [L, NP, Hkv, page]. Unlike the reference's
TPU-only gate (T=1, D % 128 == 0, page % 8 == 0), the kernel takes every
T=1 shape the models give: any page size, any D that is a multiple of 8 up
to 256.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ops.packing import unpack_int4_rows

NEG_INF = -1e30
LAUNCHES = 0  # kernel launches through paged_attention_pass
# launches of the tensor-core branch (gqa_mma), through either pass
LAUNCHES_GQA_MMA = 0

_C, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "paged_attention_launch": [_C, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _C, _C, _C, _C, _C, _C, _C, _C,
                               _C, _C, _C, _C, _C, _C, _C, _C, _C, _P, _F,
                               _P],
}
_KV_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
              torch.uint8: 3}


def fold_block(spec, qf, kf, vf, pos, n_past, slopes, m, l, acc):
    """Fold one block of keys into the running online softmax: qf [B, T,
    Hkv, rep, D], kf/vf [B, Hkv, S, D] f32 at positions `pos` [S]; keys at
    positions >= n_past[b] get -1e30 and p = 0, so a stream with no past
    keeps m = -1e30, l = 0, acc = 0. Returns the new (m, l, acc)."""
    s = torch.einsum("bthrd,bhsd->bthrs", qf, kf) * spec.kq_scale
    if slopes is not None:
        s = s + slopes[None, None, :, :, None] * pos.to(torch.float32)
    masked = (pos[None, :] >= n_past[:, None])[:, None, None, None, :]
    s = s.masked_fill(masked, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]).masked_fill(masked, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bthrs,bhsd->bthrd", p, vf)
    return m_new, l, acc


def _rows_f32(pool: torch.Tensor) -> torch.Tensor:
    """Gathered pool rows -> f32 (int4 rows unpacked to their codes)."""
    if pool.dtype == torch.uint8:
        return unpack_int4_rows(pool)
    return pool.to(torch.float32)


def paged_attention_plain(spec, pool_k, pool_v, ks, vs, tables, n_past,
                          slopes, window_pages, layer, qf):
    """Plain version of the kernel (the port of `paged._paged_online_pass`):
    qf [B, T, Hkv, rep, D] -> (m, l [B, T, Hkv, rep], acc [B, T, Hkv, rep,
    D]). A loop over logical pages: page j of every stream is looked up
    through its table (the column clamped to P - 1), dequantized, and folded
    into the running online softmax; keys at positions >= n_past[b] are
    masked. Extra memory is one page per stream."""
    B, T, Hkv, rep, D = qf.shape
    page, P = pool_k.shape[3], tables.shape[1]
    dev = qf.device
    qf = qf.to(torch.float32)
    n_past = torch.as_tensor(n_past, device=dev)
    tables = torch.as_tensor(tables, device=dev).long()
    m = torch.full((B, T, Hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, T, Hkv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, T, Hkv, rep, D), dtype=torch.float32, device=dev)
    for j in range(window_pages):
        sel = tables[:, min(j, P - 1)]  # [B] physical page ids
        kf = _rows_f32(pool_k[layer, sel])  # [B, Hkv, page, D]
        vf = _rows_f32(pool_v[layer, sel])
        if ks is not None:
            kf = kf * ks[layer, sel][..., None]
            vf = vf * vs[layer, sel][..., None]
        pos = j * page + torch.arange(page, dtype=torch.int32, device=dev)
        m, l, acc = fold_block(spec, qf, kf, vf, pos, n_past, slopes, m, l,
                               acc)
    return m, l, acc


# the kernel's launch geometry (csrc/paged_attention.cu)
THREADS = 128
WARPS = THREADS // 32
REG_FLOATS = 64  # q and acc floats a lane may hold: heads x elements x 2
SMEM_BLOCK_MAX = 232448  # 227 KB, the most a block may take
SMEM_RESIDENT = 228 * 1024 // 4 - 1024  # 4 blocks an SM (1 KB reserved each)
STAGE_BYTES = 16 * 1024  # the K and V rows of a tile, copied at once
CHUNKS = (128, 64, 32, 16)  # positions a block without a tile loop
FILL = 4  # the grid should give every SM this many blocks
# the tensor-core branch (gqa_mma): its pools, and 2 blocks an SM
MMA_DTYPES = (torch.bfloat16, torch.int8, torch.uint8)
MMA_RESIDENT = 228 * 1024 // 2 - 1024
# query heads a kv head from which the tensor-core branch takes a call
# whose heads do not fit registers: below, on int8 and int4 pools, the
# CUDA-core branch walks one or two head groups and was the faster at 2-64
# streams on the H100; from rep 5 the tensor-core branch (PERF.md)
MMA_MIN_REP = 5


class Smem(NamedTuple):
    """Byte offsets of the kernel's shared-memory regions, and their total
    (`Smem` in the source, which takes them as they are): per stage (two
    with a tile loop) the K rows of a tile at `kst` a stage (stage 0's
    region also holds the cross-warp sum of acc), the V rows at `v` (`vst`
    a stage), the k and v scales at `ks` and `vs` (`sst` a stage); then q,
    a tile's scores, m, l and the rescale of each head, the split's page
    rows, the merge's m and l of every split, and a 16-byte flag. Each
    region starts on 16 bytes."""
    kst: int
    vst: int
    sst: int
    v: int
    ks: int
    vs: int
    q: int
    p: int
    stats: int
    pages: int
    merge: int
    flag: int
    total: int


class Plan(NamedTuple):
    tile: int  # positions a stage of copies
    tps: int  # tiles a block: its positions are tile * tps (a split)
    vec: int  # bytes a lane loads at once: 16, 8 or 4
    lanes: int  # lanes a row (G, a power of two <= 32)
    nv: int  # vectors a lane and row
    heads: int  # query heads in registers at a time (HA, a power of two)
    pipe: bool  # a tile loop, q and acc of every head held across it
    smem: Smem  # the block's shared memory (MmaSmem with `mma`)
    grid: tuple[int, int]  # (B * Hkv, splits); with `mma` B * Hkv * groups
    mma: bool = False  # the tensor-core branch (gqa_mma)
    warps_m: int = 0  # its warps along the heads (the rest along the keys)


class MmaSmem(NamedTuple):
    """Byte offsets of gqa_mma's shared-memory regions and their total
    (`MmaSmem` in the source): per stage the K rows, V rows (`kst`, `vst`
    a stage; bf16 rows padded to D + 8 elements, codes as they are) and the
    k and v scales (`sst`); the three bf16 terms of q [m-tiles * 16, D + 8]
    at `q`; the K and V tiles decoded to bf16 at `cvt` (int8, int4); the
    split's page rows, the merge's m and l of every split, a 16-byte flag.
    The warps' partials for the block's merge, after the last tile, overlay
    the regions before the page rows from offset 0. Each region starts on 16
    bytes."""
    kst: int
    vst: int
    sst: int
    v: int
    ks: int
    vs: int
    q: int
    cvt: int
    pages: int
    merge: int
    flag: int
    total: int


def _row_bytes(D: int, kv_dtype) -> int:
    if kv_dtype == torch.uint8:  # planar int4
        return D // 2
    return D * kv_dtype.itemsize


def smem_layout(tile: int, tps: int, row_bytes: int, heads: int, D: int,
                rep: int, page: int, W: int, quantized: bool) -> Smem:
    """The kernel's shared memory for a plan; `heads` is min(rep, HA)."""
    def a16(n):
        return (n + 15) // 16 * 16
    stages = 2 if tps > 1 else 1
    span = tile * tps
    splits = -(-W // span)
    kst = a16(max(tile * row_bytes, WARPS * heads * D * 4))
    vst = a16(tile * row_bytes)
    sst = a16(tile * 4) if quantized else 0
    v = kst + (stages - 1) * vst  # K of stage 1 at kst
    ks = v + stages * vst
    vs = ks + stages * sst
    q = vs + stages * sst
    p = q + a16(rep * D * 4)
    stats = p + a16(rep * tile * 4)
    pages = stats + a16(rep * 3 * 4)
    merge = pages + a16(span_pages(span, page) * 8)
    flag = merge + (a16(splits * rep * 8) if splits > 1 else 0)
    return Smem(kst, vst, sst, v, ks, vs, q, p, stats, pages, merge, flag,
                flag + 16)


def mma_warps(rep: int) -> tuple[int, int]:
    """(warps along the heads, head groups) of gqa_mma: each of the warps_m
    warps holds an m-tile of 16 heads, the other warps split the keys; the
    kv head's m-tiles that a block does not hold go to the blocks of
    further head groups."""
    mtiles = -(-rep // 16)
    warps_m = 1 if mtiles == 1 else 2 if mtiles == 2 else WARPS
    return warps_m, -(-mtiles // warps_m)


def mma_smem_layout(tile: int, tps: int, row_bytes: int, D: int, rep: int,
                    page: int, W: int, quantized: bool) -> MmaSmem:
    """gqa_mma's shared memory for a plan."""
    def a16(n):
        return (n + 15) // 16 * 16
    stages = 2 if tps > 1 else 1
    span = tile * tps
    splits = -(-W // span)
    t16 = -(-tile // 16) * 16  # whole chunks of 16 keys
    es = D + 8  # elements a bf16 row
    rs = row_bytes if quantized else 2 * es
    kst = vst = a16(t16 * rs)
    sst = a16(t16 * 4) if quantized else 0
    v = stages * kst
    ks = v + stages * vst
    vs = ks + stages * sst
    q = vs + stages * sst
    warps_m, _ = mma_warps(rep)
    rows = warps_m * 16  # heads of a block
    cvt = q + a16(3 * min(rows, -(-rep // 16) * 16) * es * 2)
    after = cvt + (a16(2 * t16 * es * 2) if quantized else 0)
    pages = max(after, a16(WARPS * 16 * (D + 4) * 4))
    merge = pages + a16(span_pages(span, page) * 8)
    flag = merge + (a16(splits * min(rows, rep) * 8) if splits > 1 else 0)
    return MmaSmem(kst, vst, sst, v, ks, vs, q, cvt, pages, merge, flag,
                   flag + 16)


def _mma_plan(B: int, Hkv: int, rep: int, D: int, page: int, W: int,
              kv_dtype, sms: int, vec: int, lanes: int, nv: int,
              heads: int) -> Plan:
    """The tensor-core branch's geometry: tiles of about `STAGE_BYTES` of K
    and V rows and at least 16 keys a warp along the keys, two in flight;
    as few splits as give each SM the blocks it holds (2, or 1 where the
    shared memory asks for it); the grid's x is B * Hkv * head groups."""
    rb = _row_bytes(D, kv_dtype)
    quantized = kv_dtype != torch.bfloat16
    warps_m, groups = mma_warps(rep)
    blocks = B * Hkv * groups
    top = max(16 * (WARPS // warps_m), min(128, STAGE_BYTES // (2 * rb)))
    top = 1 << (top.bit_length() - 1)
    sizes = [top >> i for i in range(top.bit_length())]  # down to 1

    def geometry(tile, resident):
        tiles = -(-W // tile)
        splits = min(tiles, max(1, -(-resident * sms // blocks)))
        return tile, -(-tiles // splits)

    def smem(g):
        return mma_smem_layout(*g, rb, D, rep, page, W, quantized).total

    tiles = sorted({_legal_chunk(x, page, W) for x in sizes}, reverse=True)
    for limit, resident in ((MMA_RESIDENT, 2), (SMEM_BLOCK_MAX, 1)):
        g = next((g for g in (geometry(t, resident) for t in tiles)
                  if smem(g) <= limit), None)
        if g is not None:
            break
    else:
        raise ValueError(f"paged_attention: rep={rep}, D={D} needs more "
                         "shared memory than a block has")
    tile, tps = g
    return Plan(tile, tps, vec, lanes, nv, heads, False,
                mma_smem_layout(tile, tps, rb, D, rep, page, W, quantized),
                (blocks, -(-W // (tile * tps))), True, warps_m)


def span_pages(span: int, page: int) -> int:
    """The most pages `span` consecutive positions can touch."""
    return (span - 1) // page + 2


def _legal_chunk(c: int, page: int, W: int) -> int:
    """Near `c` positions, such that a tile needs one table lookup a page:
    any tile when the window lies in one page, else a multiple of the page
    size, or a divisor of it (the page itself when no divisor is near)."""
    c = min(c, W)
    if W <= page:
        return c
    if c >= page:
        return c // page * page
    d = max(x for x in range(1, c + 1) if page % x == 0)
    return d if 2 * d >= c else page


def launch_plan(B: int, Hkv: int, rep: int, D: int, page: int, W: int,
                kv_dtype, sms: int) -> Plan:
    """The kernel's geometry for one call; pure Python (the CPU tests check
    it). Where q and acc of every query head of a kv head fit in a lane's
    registers (`pipe`), a block loops over tiles of about `STAGE_BYTES` of
    K and V rows, the next tile's copies in flight, and the window is cut
    into as few splits as give each SM `FILL` blocks. Otherwise a block
    takes one tile, the largest of `CHUNKS` that fills the card the same
    way. Either keeps 4 blocks on an SM where the shared memory allows.
    Where they do not fit, the pool is bf16, int8 or int4 and rep is at
    least `MMA_MIN_REP`, the tensor-core branch takes the call
    (`_mma_plan`)."""
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"paged_attention: D={D} not supported")
    rb = _row_bytes(D, kv_dtype)
    vec = next(x for x in (16, 8, 4) if rb % x == 0)
    vpr = rb // vec
    lanes = min(32, 1 << (vpr - 1).bit_length())
    nv = -(-vpr // lanes)
    elems = nv * (2 * vec if kv_dtype == torch.uint8 else vec // (rb // D))
    cap = 1 if elems >= REG_FLOATS else min(8, REG_FLOATS // elems)
    every = 1 << (rep - 1).bit_length()
    pipe = every * elems <= REG_FLOATS // 2  # q and acc of every head
    heads = every if pipe else cap
    if not pipe and kv_dtype in MMA_DTYPES and rep >= MMA_MIN_REP:
        return _mma_plan(B, Hkv, rep, D, page, W, kv_dtype, sms, vec, lanes,
                         nv, heads)
    quantized = kv_dtype in (torch.int8, torch.uint8)
    bh = B * Hkv

    def geometry(tile):
        tiles = -(-W // tile)
        if not pipe:
            return tile, 1
        splits = min(tiles, max(1, -(-FILL * sms // bh)))
        return tile, -(-tiles // splits)

    def smem(g):
        return smem_layout(*g, rb, min(rep, heads), D, rep, page, W,
                           quantized).total

    if pipe:
        top = max(8, min(128, STAGE_BYTES // (2 * rb)))
        top = 1 << (top.bit_length() - 1)
        sizes = [top >> i for i in range(top.bit_length() - 3)]  # down to 8
    else:
        sizes = list(CHUNKS)
    cands = [geometry(t) for t in sorted(
        {_legal_chunk(x, page, W) for x in sizes}, reverse=True)]
    pool = [g for g in cands if smem(g) <= SMEM_RESIDENT] or \
        [g for g in cands if smem(g) <= SMEM_BLOCK_MAX] or \
        [g for g in (geometry(_legal_chunk(1, page, W)),)
         if smem(g) <= SMEM_BLOCK_MAX]
    if not pool:
        raise ValueError(f"paged_attention: rep={rep}, D={D} needs more "
                         "shared memory than a block has")
    if pipe:
        g = pool[0]
    else:
        g = next((g for g in pool if bh * -(-W // g[0]) >= FILL * sms),
                 pool[-1])
    tile, tps = g
    return Plan(tile, tps, vec, lanes, nv, heads, pipe,
                smem_layout(tile, tps, rb, min(rep, heads), D, rep, page, W,
                            quantized), (bh, -(-W // (tile * tps))))


_SMS: dict = {}  # device index -> SM count
_WORK: dict = {}  # (device index, stream) -> [partials, tickets, retired]


def _workspace(dev, stream: int, n_part: int, n_tickets: int):
    """f32 scratch of at least `n_part` and int32 tickets (zero) of at least
    `n_tickets`, kept per device and stream and grown as needed. The kernel
    leaves every ticket at zero. A buffer that is outgrown stays allocated
    (`retired`): a CUDA graph captured on this stream may still launch the
    kernel on it. Growing during a capture raises: a captured step must be
    run once on its capture stream first, so that its workspace is not
    taken from the graph's private pool."""
    key = (dev.index, stream)
    work = _WORK.setdefault(key, [None, None, []])
    grow_part = work[0] is None or work[0].numel() < n_part
    grow_tickets = work[1] is None or work[1].numel() < n_tickets
    if (grow_part or grow_tickets) and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError("paged_attention: the workspace would grow during "
                           "a CUDA graph capture; run the step on the capture "
                           "stream first")
    if grow_part:
        if work[0] is not None:
            work[2].append(work[0])
        work[0] = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    if grow_tickets:
        if work[1] is not None:
            work[2].append(work[1])
        work[1] = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    return work[0], work[1]


def partials_cuda(kq_scale: float, k, v, ks, vs, tables, npast, slopes,
                  W: int, q):
    """Launch csrc/paged_attention.cu over one layer: k/v [NP, Hkv, page,
    Dp] (Dp = D/2 for uint8 int4 rows), ks/vs [NP, Hkv, page] f32 or None,
    tables [B, P] int32 or None (stream b reads page b), npast [B] int32,
    slopes [Hkv, rep] f32 or None, q [B, Hkv, rep, D] f32, all contiguous
    on one card; reads positions [0, W). Returns (m, l [B, 1, Hkv, rep],
    acc [B, 1, Hkv, rep, D]), views of one new buffer. The callers check
    the arguments and count the launch; this checks the alignment of the
    base pointers the kernel's vector copies need and counts the launches
    of the tensor-core branch."""
    global LAUNCHES_GQA_MMA
    dev = q.device
    B, Hkv, rep, D = q.shape
    NP, _, page, _ = k.shape
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    plan = launch_plan(B, Hkv, rep, D, page, W, k.dtype, _SMS[dev.index])
    for t, align in ((k, plan.vec), (v, plan.vec), (ks, 4), (vs, 4),
                     (q, 16)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"paged_attention: a base pointer is not "
                             f"aligned to {align} bytes")
    BH = B * Hkv
    blocks, splits = plan.grid
    stream = torch.cuda.current_stream(dev).cuda_stream
    stride = -(-rep * (D + 2) // 4) * 4  # a split's partials, on 16 bytes
    part, tickets = _workspace(
        dev, stream, BH * splits * stride if splits > 1 else 0, blocks)
    out = torch.empty(BH * rep * (D + 2), dtype=torch.float32, device=dev)
    acc = out[:BH * rep * D].view(B, 1, Hkv, rep, D)
    m = out[BH * rep * D:BH * rep * (D + 1)].view(B, 1, Hkv, rep)
    l = out[BH * rep * (D + 1):].view(B, 1, Hkv, rep)
    lib = _build.load("paged_attention", _SIGNATURES)
    ptr = _build.ptr
    err = lib.paged_attention_launch(
        _KV_DTYPES[k.dtype], ptr(q), ptr(k), ptr(v), ptr(ks), ptr(vs),
        ptr(tables), ptr(npast), ptr(slopes), ptr(part), ptr(tickets),
        ptr(m), ptr(l), ptr(acc), B, NP, Hkv, rep, D, page,
        1 if tables is None else tables.shape[1], W, plan.tile, plan.tps,
        splits, plan.vec, plan.nv, plan.lanes, plan.heads, int(plan.pipe),
        plan.warps_m, (ctypes.c_int * len(plan.smem))(*plan.smem),
        float(kq_scale), ctypes.c_void_p(stream),
    )
    _build.check(err, "paged_attention_launch")
    LAUNCHES_GQA_MMA += plan.mma
    return m, l, acc


def paged_attention_cuda(spec, pool_k, pool_v, ks, vs, tables, n_past,
                         slopes, window_pages, layer, qf):
    """Launch csrc/paged_attention.cu; see `paged_attention_pass`."""
    global LAUNCHES
    dev = qf.device
    B, T, Hkv, rep, D = qf.shape
    L, NP, Hp, page, Dp = pool_k.shape
    packed = pool_k.dtype == torch.uint8
    quantized = ks is not None
    if T != 1 or Hp != Hkv or Dp != (D // 2 if packed else D) \
            or pool_v.shape != pool_k.shape:
        raise ValueError(f"paged_attention: pool {tuple(pool_k.shape)} vs "
                         f"query {tuple(qf.shape)}")
    if D % 8 or D > 256 or window_pages < 1 or not 0 <= layer < L:
        raise ValueError(f"paged_attention: D={D}, window_pages="
                         f"{window_pages}, layer={layer} not supported")
    if pool_k.dtype not in _KV_DTYPES or pool_v.dtype != pool_k.dtype \
            or quantized != (pool_k.dtype in (torch.int8, torch.uint8)):
        raise ValueError(f"paged_attention: pool dtype {pool_k.dtype}")
    tensors = [pool_k, pool_v] + ([ks, vs] if quantized else [])
    for t in tensors:
        if t.device != dev or not t[layer].is_contiguous():
            raise ValueError("paged_attention: each layer of the pool "
                             f"tensors must be contiguous on {dev}")
    if quantized and (ks.dtype != torch.float32 or vs.dtype != torch.float32
                      or ks.shape != (L, NP, Hkv, page)
                      or vs.shape != ks.shape):
        raise ValueError("paged_attention: scales must be f32 "
                         "[L, NP, Hkv, page]")
    tables = torch.as_tensor(tables, device=dev).to(torch.int32).contiguous()
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)}")
    npast = torch.as_tensor(n_past, device=dev).to(torch.int32).contiguous()
    if npast.shape != (B,):
        raise ValueError(f"paged_attention: n_past {tuple(npast.shape)}")
    if slopes is not None:
        slopes = slopes.to(device=dev, dtype=torch.float32).contiguous()
        if slopes.shape != (Hkv, rep):
            raise ValueError("paged_attention: slopes must be [Hkv, rep]")
    out = partials_cuda(
        spec.kq_scale, pool_k[layer], pool_v[layer],
        ks[layer] if quantized else None, vs[layer] if quantized else None,
        tables, npast, slopes, window_pages * page,
        qf[:, 0].to(torch.float32).contiguous())
    LAUNCHES += 1
    return out


def paged_attention_pass(spec, pool_k, pool_v, ks, vs, tables, n_past,
                         slopes: Optional[torch.Tensor], window_pages: int,
                         layer: int, qf: torch.Tensor):
    """online_pass hook (paged.paged_forward_batched): qf [B, 1, Hkv, rep,
    D] -> (m, l [B, 1, Hkv, rep], acc [B, 1, Hkv, rep, D]) over layer
    `layer` of the pool, positions [0, window_pages * page) of each stream
    read through its row of `tables` [B, P]; keys at positions >= n_past[b]
    are masked. Same arguments and results as `paged_attention_plain`."""
    if qf.shape[1] != 1:
        raise ValueError("paged_attention_pass is decode-shaped (T=1)")
    fn = paged_attention_cuda if qf.is_cuda else paged_attention_plain
    return fn(spec, pool_k, pool_v, ks, vs, tables, n_past, slopes,
              window_pages, layer, qf)
