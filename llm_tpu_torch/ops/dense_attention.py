"""T=1 decode attention over the dense head-major KV cache.

The counterpart of `llm_tpu/ops/dense_attention.py`. `dense_attention_pass`
is the `online_pass` hook of `models/forward._attention_batched`: it turns
the query of one new token per stream into online-softmax partials
(m, l, acc) over the first `window` cached positions of one layer, which the
caller merges with the token's own key. On a CUDA tensor it launches the
hand-written paged-attention kernel `csrc/paged_attention.cu`, which
replaces the TPU kernels K2 and K4: one layer of the dense cache
[B, Hkv, S, D] is a pool of B pages of S positions, stream b reading page
b. On a CPU tensor it runs `dense_attention_plain`, the
block-wise online softmax that `forward._attention_batched` also uses for
long prefills. Unlike the reference's TPU-only gate, the kernel takes any
window W >= 1 and any head dim D that is a multiple of 8 up to 256.
"""

from __future__ import annotations

from typing import Optional

import torch

from llm_tpu_torch.ops.paged_attention import (
    NEG_INF,
    fold_block,
    partials_cuda,
)

LAUNCHES = 0  # kernel launches through dense_attention_pass

_KV_DTYPES = (torch.bfloat16, torch.float32, torch.int8)


def online_cache_pass_batched(
    spec,
    qf: torch.Tensor,  # [B, T, Hkv, rep, D] f32
    k_cache,  # (codes [B, Hkv, S, D], scale [B, Hkv, S] | None)
    v_cache,
    n_past: torch.Tensor,  # [B] int
    slopes: Optional[torch.Tensor],  # [Hkv, rep]
    block: int,
):
    """Flash-style pass over the cached keys in blocks of `block` positions
    (the last block may be shorter); per-stream n_past masks. Returns the
    partials (m, l [B, T, Hkv, rep], acc [B, T, Hkv, rep, D])."""
    kcod, kscl = k_cache
    vcod, vscl = v_cache
    B, S = kcod.shape[0], kcod.shape[2]
    _, T, Hkv, rep, D = qf.shape
    dev = qf.device
    m = torch.full((B, T, Hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, T, Hkv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, T, Hkv, rep, D), dtype=torch.float32, device=dev)
    for start in range(0, S, block):
        stop = min(start + block, S)
        kf = kcod[:, :, start:stop].to(torch.float32)
        vf = vcod[:, :, start:stop].to(torch.float32)
        if kscl is not None:
            kf = kf * kscl[:, :, start:stop, None]
            vf = vf * vscl[:, :, start:stop, None]
        pos = torch.arange(start, stop, dtype=torch.int32, device=dev)
        m, l, acc = fold_block(spec, qf, kf, vf, pos, n_past, slopes, m, l,
                               acc)
    return m, l, acc


def dense_attention_plain(spec, cache_k, cache_v, ks, vs, n_past, window,
                          layer, qf, slopes=None):
    """Plain version of the kernel, same arguments and results as
    `dense_attention_pass`: the online pass over layer `layer`'s first
    `window` positions in blocks of 512."""
    kc = (cache_k[layer, :, :, :window],
          ks[layer, :, :, :window] if ks is not None else None)
    vc = (cache_v[layer, :, :, :window],
          vs[layer, :, :, :window] if vs is not None else None)
    return online_cache_pass_batched(spec, qf.to(torch.float32), kc, vc,
                                     n_past, slopes, min(512, window))


def dense_attention_cuda(spec, cache_k, cache_v, ks, vs, n_past, window,
                         layer, qf, slopes=None):
    """Launch csrc/paged_attention.cu over the layer seen as a pool of one
    page a stream; see `dense_attention_pass`."""
    global LAUNCHES
    dev = qf.device
    B, T, Hkv, rep, D = qf.shape
    L, Bc, Hc, S, Dc = cache_k.shape
    quantized = ks is not None
    if (Bc, Hc, Dc) != (B, Hkv, D) or cache_v.shape != cache_k.shape:
        raise ValueError(f"dense_attention: cache {tuple(cache_k.shape)} vs "
                         f"query {tuple(qf.shape)}")
    if D % 8 or D > 256 or not 1 <= window <= S or not 0 <= layer < L:
        raise ValueError(f"dense_attention: D={D}, window={window}, "
                         f"layer={layer} not supported for S={S}, L={L}")
    if cache_k.dtype not in _KV_DTYPES or quantized != (
            cache_k.dtype == torch.int8) or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"dense_attention: cache dtype {cache_k.dtype}")
    # the kernel reads one layer: that slice must be contiguous (a B=1 view
    # of one slot of a batched cache is, though the whole view is not)
    tensors = [cache_k, cache_v] + ([ks, vs] if quantized else [])
    for t in tensors:
        if t.device != dev or not t[layer].is_contiguous():
            raise ValueError("dense_attention: each layer of the cache "
                             f"tensors must be contiguous on {dev}")
    if quantized and (ks.dtype != torch.float32 or vs.dtype != torch.float32
                      or ks.shape != cache_k.shape[:-1]
                      or vs.shape != ks.shape):
        raise ValueError("dense_attention: int8 scales must be f32 "
                         "[L, B, Hkv, S]")
    npast = torch.as_tensor(n_past, device=dev).to(torch.int32).contiguous()
    if npast.shape != (B,):
        raise ValueError(f"dense_attention: n_past shape {tuple(npast.shape)}")
    if slopes is not None:
        slopes = slopes.to(device=dev, dtype=torch.float32).contiguous()
        if slopes.shape != (Hkv, rep):
            raise ValueError("dense_attention: slopes must be [Hkv, rep]")
    out = partials_cuda(
        spec.kq_scale, cache_k[layer], cache_v[layer],
        ks[layer] if quantized else None, vs[layer] if quantized else None,
        None, npast, slopes, window,
        qf[:, 0].to(torch.float32).contiguous())
    LAUNCHES += 1
    return out


def dense_attention_pass(spec, cache_k, cache_v, ks, vs, n_past, window,
                         layer, qf, slopes=None):
    """online_pass hook (models/forward._attention_batched): qf
    [B, 1, Hkv, rep, D] -> (m, l [B, 1, Hkv, rep], acc [B, 1, Hkv, rep, D])
    over layer `layer` of the dense head-major cache [L, B, Hkv, S, D],
    reading only the first `window` positions; keys at positions >=
    n_past[b] are masked. ks/vs are the int8 cache's scales [L, B, Hkv, S]."""
    if qf.shape[1] != 1:
        raise ValueError("dense_attention_pass is decode-shaped (T=1)")
    fn = dense_attention_cuda if qf.is_cuda else dense_attention_plain
    return fn(spec, cache_k, cache_v, ks, vs, n_past, window, layer, qf,
              slopes)
