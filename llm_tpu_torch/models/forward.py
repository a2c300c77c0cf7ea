"""The spec-driven decoder forward pass, in torch.

The counterpart of `llm_tpu/models/forward.py`:

    forward(spec, params, ids[T], n_past, cache) -> (logits[T, V], hidden[T, E], cache)

- The KV cache is a dense head-major [L, B, H_kv, n_ctx, D] buffer of
  absolute positions (bf16, f32, or int8 codes with per-(position, head)
  f32 scales). It is updated in place.
- A Python loop over the layer stack takes the place of the reference's
  `lax.scan`; each layer is a view of the stacked weights.
- Attention reads the cached keys below n_past plus the chunk's own keys.
  Decode steps (T=1) go through ops/dense_attention.py (the hand-written
  kernel on the card); prefill chunks take plain torch: materialized
  scores, or a block-wise online softmax when the scores would exceed
  _ONLINE_MIN_SCORE_BYTES.
- The new keys/values of all layers are written to the cache after the
  layer loop, at each stream's own n_past.
- KQ numerics mirror ggml: scale 1/sqrt(n_embd/n_head), optional ALiBi added
  after scaling, causal mask, f32 softmax.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from llm_tpu_torch.models.params import LayerParams, ModelParams
from llm_tpu_torch.models.spec import ModelSpec
from llm_tpu_torch.ops import dense_attention
from llm_tpu_torch.ops.dense_attention import online_cache_pass_batched
from llm_tpu_torch.ops.layers import (
    alibi_slopes,
    gelu,
    layer_norm,
    rms_norm,
    rope,
    silu,
)
from llm_tpu_torch.ops.packing import split_fused
from llm_tpu_torch.ops.qmatmul import qmatmul, quant_rows_lookup

NEG_INF = -1e30


@dataclass
class KVCache:
    """Dense KV cache, absolute positions, head-major [L, B, H_kv, S, D],
    with K stored after rope. With k_scale/v_scale present the cache is
    INT8: k/v hold int8 codes and the scales are per (position, kv-head) f32
    amax/127."""

    k: torch.Tensor  # [L, B, H_kv, S, D]
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, B, H_kv, S]
    v_scale: Optional[torch.Tensor] = None


def init_cache(spec: ModelSpec, dtype=torch.bfloat16, device=None) -> KVCache:
    """Single-stream (B=1) cache."""
    return init_cache_batched(spec, 1, dtype, device)


def init_cache_batched(spec: ModelSpec, batch: int, dtype=torch.bfloat16,
                       device=None) -> KVCache:
    """Batched cache, layer-major head-major [L, B, H_kv, S, D]; dtype is a
    torch float dtype or "int8"."""
    shape = (spec.n_layer, batch, spec.n_head_kv, spec.n_ctx, spec.head_dim)
    if dtype in (torch.int8, "int8"):
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dense caches take bf16/f32/int8, not {dtype}")
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _dequant_kv(codes: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """[.., S, D] codes (+ [.., S] scales) -> f32."""
    x = codes.to(torch.float32)
    if scale is not None:
        x = x * scale[..., None]
    return x


def _quant_kv(x: torch.Tensor, qmax: float = 127.0):
    """f32 [.., H, D] -> (int8 codes, f32 scales [.., H]) per head-row."""
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = amax / qmax
    inv = torch.where(scale > 0,
                      1.0 / torch.where(scale == 0, torch.ones_like(scale),
                                        scale),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(x * inv[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def _norm(spec: ModelSpec, x, w, b):
    if spec.norm == "rms":
        return rms_norm(x, w)
    return layer_norm(x, w, b)


# Online-softmax streaming over the cached keys kicks in when the
# materialized [T, H, S+T] f32 score tensor would exceed this many bytes.
# Tests monkeypatch it to force the path.
_ONLINE_MIN_SCORE_BYTES = 64 << 20
_KV_BLOCK = 512


def _use_online(T: int, H: int, S: int) -> tuple[bool, int]:
    block = min(_KV_BLOCK, S)
    ok = S % block == 0 and T * H * (S + T) * 4 > _ONLINE_MIN_SCORE_BYTES
    return ok, block


def _qkv_proj(layer: LayerParams, x: torch.Tensor):
    """The three attention projections of `x` [N, E] (+ biases), through ONE
    kernel launch when the fused q|k|v weight is present."""
    if layer.w_qkv is not None:
        q, k, v = split_fused(qmatmul(x, layer.w_qkv), layer.w_qkv.splits)
    else:
        q = qmatmul(x, layer.wq)
        k = qmatmul(x, layer.wk)
        v = qmatmul(x, layer.wv)
    if layer.bq is not None:
        q = q + layer.bq
    if layer.bk is not None:
        k = k + layer.bk
    if layer.bv is not None:
        v = v + layer.bv
    return q, k, v


def _ffn(spec: ModelSpec, layer: LayerParams, x: torch.Tensor) -> torch.Tensor:
    if spec.ffn == "swiglu":
        if layer.w_gate_up is not None:
            gate, up = split_fused(qmatmul(x, layer.w_gate_up),
                                   layer.w_gate_up.splits)
        else:
            up = qmatmul(x, layer.w_up)
            gate = qmatmul(x, layer.w_gate)
        h = silu(gate) * up
    else:
        h = qmatmul(x, layer.w_up)
        if layer.b_up is not None:
            h = h + layer.b_up
        h = gelu(h)
    h = qmatmul(h, layer.w_down)
    if layer.b_down is not None:
        h = h + layer.b_down
    return h


def _slopes(spec: ModelSpec, device) -> Optional[torch.Tensor]:
    if spec.alibi_bias_max <= 0.0:
        return None
    return alibi_slopes(spec.n_head, spec.alibi_bias_max, device).reshape(
        spec.n_head_kv, spec.n_head // spec.n_head_kv
    )


def _attention_batched(
    spec: ModelSpec,
    layer: LayerParams,
    a: torch.Tensor,  # [B, T, E] normed input
    positions: torch.Tensor,  # [B, T] absolute
    n_past: torch.Tensor,  # [B] on a's device
    k_cache,  # ([B, H_kv, S, D] codes, [B, H_kv, S] scale | None)
    v_cache,
    online_pass=None,  # callable qf -> (m, l, acc): cached-KV attention
    #                    done elsewhere (the dense or paged kernel)
    qmax: Optional[float] = None,  # None: raw kv; else the in-flight kv
    #    round-trips through codes of this range (127 int8, 7 int4 pools)
):
    B, T, E = a.shape
    S = k_cache[0].shape[2] if k_cache[0] is not None else 0
    H, Hkv, D = spec.n_head, spec.n_head_kv, spec.head_dim
    rep = H // Hkv
    dev = a.device

    q, k, v = _qkv_proj(layer, a.reshape(B * T, E))
    q = q.reshape(B, T, H, D)
    k = k.reshape(B, T, Hkv, D)
    v = v.reshape(B, T, Hkv, D)

    if spec.rope_mode >= 0 and spec.n_rot > 0:
        q = rope(q, positions, spec.n_rot, spec.rope_mode,
                 spec.rope_freq_base, spec.rope_freq_scale)
        k = rope(k, positions, spec.n_rot, spec.rope_mode,
                 spec.rope_freq_base, spec.rope_freq_scale)

    qf = q.to(torch.float32).reshape(B, T, Hkv, rep, D)
    if qmax is not None:  # quantized cache: in-flight kv must round-trip
        k_out = _quant_kv(k.to(torch.float32), qmax)
        v_out = _quant_kv(v.to(torch.float32), qmax)
        kf = _dequant_kv(*k_out)
        vf = _dequant_kv(*v_out)
    else:
        k_out, v_out = k, v
        kf = k.to(torch.float32)
        vf = v.to(torch.float32)

    slopes = _slopes(spec, dev)
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    new_pos = n_past[:, None] + ar[None, :]  # [B, T]
    chunk_valid = (ar[None, :] <= ar[:, None]).expand(B, T, T)

    if online_pass is not None:
        use_online, block = True, 0
    else:
        use_online, block = _use_online(B * T, H, S)
    if use_online:
        if online_pass is not None:
            m, l, acc = online_pass(qf)
        else:
            m, l, acc = online_cache_pass_batched(
                spec, qf, k_cache, v_cache, n_past, slopes, block
            )
        sn = torch.einsum("bthrd,buhd->bthru", qf, kf) * spec.kq_scale
        if slopes is not None:
            sn = sn + (slopes[None, None, :, :, None]
                       * new_pos.to(torch.float32)[:, None, None, None, :])
        masked = ~chunk_valid[:, :, None, None, :]
        sn = sn.masked_fill(masked, NEG_INF)
        m2 = torch.maximum(m, sn.amax(dim=-1))
        p = torch.exp(sn - m2[..., None]).masked_fill(masked, 0.0)
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bthru,buhd->bthrd", p, vf)
        out = (acc / l[..., None]).reshape(B * T, H * D)
    else:
        kc = _dequant_kv(*k_cache)  # [B, H_kv, S, D] f32
        vc = _dequant_kv(*v_cache)
        sc = torch.einsum("bthrd,bhsd->bthrs", qf, kc)
        sn = torch.einsum("bthrd,buhd->bthru", qf, kf)
        scores = torch.cat([sc, sn], dim=-1) * spec.kq_scale

        cache_pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        key_pos = torch.cat([cache_pos.expand(B, S), new_pos], dim=-1)
        if slopes is not None:
            scores = scores + (slopes[None, None, :, :, None]
                               * key_pos.to(torch.float32)[:, None, None,
                                                           None, :])
        cache_valid = (cache_pos < n_past[:, None])[:, None, :].expand(B, T, S)
        valid = torch.cat([cache_valid, chunk_valid], dim=-1)
        scores = scores.masked_fill(~valid[:, :, None, None, :], NEG_INF)

        probs = torch.softmax(scores, dim=-1)
        pc, pn = probs[..., :S], probs[..., S:]
        out = torch.einsum("bthrs,bhsd->bthrd", pc, vc)
        out = out + torch.einsum("bthru,buhd->bthrd", pn, vf)
        out = out.reshape(B * T, H * D)

    out = qmatmul(out, layer.wo)
    if layer.bo is not None:
        out = out + layer.bo
    return out.reshape(B, T, E), k_out, v_out


def _layer_batched(spec, h, layer, positions, n_past, k_cache, v_cache,
                   online_pass=None, qmax=None):
    B, T, E = h.shape

    def norm1(x):
        return _norm(spec, x, layer.ln1_w, layer.ln1_b)

    def norm2(x):
        return _norm(spec, x, layer.ln2_w, layer.ln2_b)

    def ffn(x):
        return _ffn(spec, layer, x.reshape(B * T, E)).reshape(B, T, E)

    def attend(a):
        return _attention_batched(
            spec, layer, a, positions, n_past, k_cache, v_cache,
            online_pass=online_pass, qmax=qmax,
        )

    if spec.residual == "sequential":
        a = norm1(h)
        attn, k_new, v_new = attend(a)
        h = h + attn
        h = h + ffn(norm2(h))
    elif spec.residual == "parallel_shared_ln":
        a = norm1(h)
        attn, k_new, v_new = attend(a)
        h = h + attn + ffn(a)
    elif spec.residual == "parallel_two_ln":
        a = norm1(h)
        attn, k_new, v_new = attend(a)
        h = h + attn + ffn(norm2(h))
    else:
        raise ValueError(f"unknown residual topology {spec.residual}")
    return h, k_new, v_new


def run_layers_batched(spec: ModelSpec, layers: LayerParams, h, positions,
                       n_past, cache: KVCache, W: int):
    """Run the layer stack over `h` [B, T, E] (the reference's
    scan_layers_batched). Returns (h, k_news, v_news), the new keys/values
    of each layer ([B, T, H_kv, D], or (codes, scales) when int8).

    Decode steps (T=1) take the cached-KV attention through
    `dense_attention_pass`, which reads the layer's slice of the full cache
    in place: the kernel on the card, its plain version on the CPU.
    Prefill chunks read the windowed cache slices."""
    quantized = cache.k_scale is not None
    qmax = 127.0 if quantized else None
    decode = h.shape[1] == 1
    slopes = _slopes(spec, h.device)
    k_news, v_news = [], []
    for l in range(cache.k.shape[0]):
        layer = layers.layer(l)
        if decode:
            online = functools.partial(
                dense_attention.dense_attention_pass,
                spec, cache.k, cache.v, cache.k_scale, cache.v_scale,
                n_past, W, l, slopes=slopes,
            )
            h, k_new, v_new = _layer_batched(
                spec, h, layer, positions, n_past, (None, None),
                (None, None), online_pass=online, qmax=qmax,
            )
        else:
            kc = (cache.k[l, :, :, :W],
                  cache.k_scale[l, :, :, :W] if quantized else None)
            vc = (cache.v[l, :, :, :W],
                  cache.v_scale[l, :, :, :W] if quantized else None)
            h, k_new, v_new = _layer_batched(spec, h, layer, positions,
                                             n_past, kc, vc, qmax=qmax)
        k_news.append(k_new)
        v_news.append(v_new)
    return h, k_news, v_news


def write_cache_batched(cache: KVCache, k_news: list, v_news: list,
                        n_past: Sequence[int],
                        write_mask: Optional[Sequence[bool]] = None
                        ) -> KVCache:
    """Write each layer's new K/V rows [B, T, H, D] (or (codes, scales) when
    int8) into the cache in place, at each stream's own n_past. Streams
    with write_mask False are skipped. Like the reference's
    dynamic_update_slice, a start that would run past the end is clamped
    to S - T."""
    quantized = cache.k_scale is not None
    S = cache.k.shape[3]
    for b, p in enumerate(n_past):
        if write_mask is not None and not write_mask[b]:
            continue
        for l, (kn, vn) in enumerate(zip(k_news, v_news)):
            if quantized:
                pairs = ((cache.k, kn[0]), (cache.v, vn[0]),
                         (cache.k_scale, kn[1]), (cache.v_scale, vn[1]))
            else:
                pairs = ((cache.k, kn), (cache.v, vn))
            for dst, new in pairs:
                T = new.shape[1]
                start = min(max(int(p), 0), S - T)
                # new [B, T, H(, D)] -> the cache's head-major [H, T(, D)]
                dst[l, b, :, start : start + T] = new[b].transpose(0, 1)
    return cache


def embed_batched(spec: ModelSpec, params: ModelParams, ids, positions):
    """[B, T] ids -> [B, T, E] f32 embeddings (+ post-embed norm / learned
    positions per spec)."""
    B, T = ids.shape
    h = quant_rows_lookup(params.wte, ids.reshape(-1)).reshape(B, T, -1)
    if spec.post_embed_norm:
        h = layer_norm(h, params.emb_norm_w, params.emb_norm_b)
    if spec.learned_pos:
        h = h + quant_rows_lookup(params.wpe, positions.reshape(-1)).reshape(
            B, T, -1
        )
    return h


def head_batched(spec: ModelSpec, params: ModelParams, h):
    """Final norm + lm_head: [B, T, E] hidden -> (logits [B, T, V] f32,
    normed hidden [B, T, E] f32)."""
    B, T, E = h.shape
    h = _norm(spec, h, params.final_norm_w, params.final_norm_b)
    head = params.lm_head if params.lm_head is not None else params.wte
    logits = qmatmul(h.reshape(B * T, E), head)
    if params.lm_head_b is not None:
        logits = logits + params.lm_head_b
    return (logits.reshape(B, T, -1).to(torch.float32),
            h.to(torch.float32))


def forward_batched(
    spec: ModelSpec,
    params: ModelParams,
    ids: torch.Tensor,  # [B, T] int
    n_past: Sequence[int],  # [B] host ints
    cache: KVCache,  # [L, B, H_kv, S, D]
    window: Optional[int] = None,
    write_mask: Optional[Sequence[bool]] = None,
):
    """Batched forward over B independent streams sharing the weights.

    Returns (logits [B, T, V] f32, hidden [B, T, E] f32, cache), the cache
    updated in place. `window` bounds cache reads and must cover
    max(n_past); `write_mask` (default all True) skips the cache write of
    masked streams."""
    dev = cache.k.device
    ids = torch.as_tensor(ids, device=dev)
    B, T = ids.shape
    n_past_host = [int(p) for p in n_past]
    npast = torch.tensor(n_past_host, dtype=torch.int32, device=dev)
    positions = npast[:, None] + torch.arange(T, dtype=torch.int32,
                                              device=dev)[None, :]
    h = embed_batched(spec, params, ids, positions)

    W = cache.k.shape[3] if window is None else min(window, cache.k.shape[3])
    h, k_news, v_news = run_layers_batched(spec, params.layers, h, positions,
                                           npast, cache, W)
    write_cache_batched(cache, k_news, v_news, n_past_host, write_mask)
    logits, h = head_batched(spec, params, h)
    return logits, h, cache


def forward(spec: ModelSpec, params: ModelParams, ids, n_past: int,
            cache: KVCache, window: Optional[int] = None):
    """Returns (logits [T, n_vocab] f32, hidden [T, E] f32, cache): the B=1
    view of forward_batched. `window` limits how much of the cache
    attention reads; callers pick a bucket >= n_past (window_bucket)."""
    ids = torch.as_tensor(ids, device=cache.k.device)
    logits, h, cache = forward_batched(spec, params, ids[None, :],
                                       [int(n_past)], cache, window)
    return logits[0], h[0], cache


def _check_window(window, n_past, extra: int = 0) -> None:
    """A read window that does not cover n_past (+extra in-flight tokens)
    would silently drop cached context from attention: a hard error."""
    if window is None:
        return
    past = max(int(p) for p in (n_past if isinstance(n_past, (list, tuple))
                                else [n_past]))
    if window < past + extra:
        raise ValueError(
            f"attention window {window} does not cover n_past={past}"
            + (f" + {extra} in-flight tokens" if extra else "")
            + "; pick a bucket with window_bucket()"
        )


@torch.no_grad()
def forward_step(spec, params, ids, n_past, cache, window=None):
    """Entry point of one evaluation step; the cache is updated in place."""
    _check_window(window, n_past)
    return forward(spec, params, ids, n_past, cache, window)


def window_bucket(n_past: int, n_ctx: int, granule: int = 512) -> int:
    """Read-window bucket covering n_past: multiples of `granule` (bounded
    by n_ctx), so decode cache traffic tracks the actual context length."""
    if n_ctx <= granule:
        return n_ctx
    w = ((max(n_past, 1) + granule - 1) // granule) * granule
    return min(n_ctx, max(w, granule))
