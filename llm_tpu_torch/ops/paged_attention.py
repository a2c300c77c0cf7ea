"""Decode attention over the paged KV pool, read through page tables.

The counterpart of `llm_tpu/ops/paged_attention.py`. `paged_attention_pass`
is the `online_pass` hook of `models/forward._attention_batched` for paged
caches: it turns the query of one new token per stream into online-softmax
partials (m, l, acc) over the logical positions below `window_pages * page`
of one layer, each position read from the physical page that the stream's
table names, and the caller merges them with the token's own key. On a CUDA
tensor it launches the hand-written kernel `csrc/paged_attention.cu` (the
port of the TPU kernel K4); on a CPU tensor it runs `paged_attention_plain`,
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
import math
from typing import Optional

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ops.packing import unpack_int4_rows

NEG_INF = -1e30
LAUNCHES = 0  # kernel launches through paged_attention_pass

_C, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "paged_attention_launch": [_C, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _C, _C, _C, _C, _C, _C, _C,
                               _C, _C, _F, _P],
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


def _chunk(window: int, bh: int, sms: int) -> int:
    """Positions per block: 64, or fewer so that B*Hkv*chunks fills the
    card twice over (never below 16)."""
    chunk = 64
    while chunk > 16 and bh * math.ceil(window / chunk) < 2 * sms:
        chunk //= 2
    return chunk


def partials_cuda(kq_scale: float, k, v, ks, vs, tables, npast, slopes,
                  W: int, q):
    """Launch csrc/paged_attention.cu over one layer: k/v [NP, Hkv, page,
    Dp] (Dp = D/2 for uint8 int4 rows), ks/vs [NP, Hkv, page] f32 or None,
    tables [B, P] int32 or None (stream b reads page b), npast [B] int32,
    slopes [Hkv, rep] f32 or None, q [B, Hkv, rep, D] f32, all contiguous
    on one card; reads positions [0, W). Returns (m, l [B, 1, Hkv, rep],
    acc [B, 1, Hkv, rep, D]). The callers check the arguments and count the
    launch."""
    dev = q.device
    B, Hkv, rep, D = q.shape
    NP, _, page, _ = k.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = _chunk(W, B * Hkv, sms)
    nc = math.ceil(W / chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    pm = torch.empty((B * Hkv, nc, rep), **f32)
    pl = torch.empty((B * Hkv, nc, rep), **f32)
    pacc = torch.empty((B * Hkv, nc, rep, D), **f32)
    m = torch.empty((B, Hkv, rep), **f32)
    l = torch.empty((B, Hkv, rep), **f32)
    acc = torch.empty((B, Hkv, rep, D), **f32)
    lib = _build.load("paged_attention", _SIGNATURES)
    ptr = _build.ptr
    err = lib.paged_attention_launch(
        _KV_DTYPES[k.dtype], ptr(q), ptr(k), ptr(v), ptr(ks), ptr(vs),
        ptr(tables), ptr(npast), ptr(slopes), ptr(pm), ptr(pl), ptr(pacc),
        ptr(m), ptr(l), ptr(acc), B, NP, Hkv, rep, D, page,
        1 if tables is None else tables.shape[1], W, chunk, float(kq_scale),
        _build.stream_ptr(dev),
    )
    _build.check(err, "paged_attention_launch")
    return m[:, None], l[:, None], acc[:, None]


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
