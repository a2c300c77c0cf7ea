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
  layer loop, at each stream's own n_past, read from a device tensor: one
  indexed write per cache tensor, predicated by a write mask on the device.
- KQ numerics mirror ggml: scale 1/sqrt(n_embd/n_head), optional ALiBi added
  after scaling, causal mask, f32 softmax.
- `decode_loop` (one stream) and `decode_loop_batched` (B streams)
  generate n_steps tokens with on-device sampling; on the card their T=1
  step is a captured CUDA graph, replayed once a token.
- `forward_replay` runs one forward of static shape (the speculative
  verify and tail evaluations) as a captured CUDA graph on the card.
- Under tensor parallelism (`parallel/sharding.shard_params`) each rank's
  params carry a `tp` handle: the forward runs with the rank's ShardSpec
  (`local_spec`) over its heads, FFN columns and vocabulary rows, sums the
  partial products of wo and the FFN's down projection over the `model`
  axis before their biases, and gathers the vocabulary shards of the
  logits. Such a forward never runs as a CUDA graph (`_graph_ok`).
  Where the batched cache holds only the rank's `data` block of the
  streams (`shard_cache(batched=True)`, the engines' dense caches), the
  batched forward runs those rows and gathers every stream's logits over
  `data`.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from llm_tpu_torch import trace
from llm_tpu_torch.models.params import LayerParams, ModelParams
from llm_tpu_torch.models.spec import ModelSpec, ShardSpec
from llm_tpu_torch.ops import dense_attention, paged_attention
from llm_tpu_torch.ops import qmatmul as qmatmul_mod
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
from llm_tpu_torch.ops.sampling import (
    BatchedDeviceSampler,
    DeviceSampler,
    bias_vector,
    device_sample_step,
)

NEG_INF = -1e30


@dataclass
class KVCache:
    """Dense KV cache, absolute positions, head-major [L, B, H_kv, S, D],
    with K stored after rope. With k_scale/v_scale present the cache is
    INT8: k/v hold int8 codes and the scales are per (position, kv-head) f32
    amax/127. `graphs` holds the CUDA graphs captured over this cache
    (`decode_loop`, `decode_loop_batched`, `forward_replay`), which hold
    its tensors' addresses."""

    k: torch.Tensor  # [L, B, H_kv, S, D]
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, B, H_kv, S]
    v_scale: Optional[torch.Tensor] = None
    graphs: dict = field(default_factory=dict, repr=False, compare=False)


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


def local_spec(spec: ModelSpec, params) -> ModelSpec:
    """The spec a forward over `params` runs with: `spec` itself, or for
    tensor-parallel params (which carry a `tp` handle) the rank's
    ShardSpec."""
    tp = getattr(params, "tp", None)
    if tp is None or isinstance(spec, ShardSpec):
        return spec
    return tp.view(spec)


def _tp(spec):
    """The tensor-parallel handle of a ShardSpec, else None."""
    return spec.tp if isinstance(spec, ShardSpec) else None


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
    tp = _tp(spec)
    if tp is not None and tp.ffn:
        h = tp.reduce(h)  # the partial sums of the rank's FFN columns
    if layer.b_down is not None:
        h = h + layer.b_down
    return h


def _slopes(spec: ModelSpec, device) -> Optional[torch.Tensor]:
    """ALiBi slopes [H_kv, rep] of `spec` on `device` (None without ALiBi),
    built once per geometry and device: a forward, and so a captured decode
    step, copies nothing from the host for them. Callers must not write to
    the result."""
    if spec.alibi_bias_max <= 0.0:
        return None
    if isinstance(spec, ShardSpec):
        # the model's slopes, sliced to the rank's kv heads (a view)
        full = _slopes_on(spec.n_head_global, spec.n_head_kv_global,
                          spec.alibi_bias_max, torch.device(device))
        return full[spec.kv_start:spec.kv_start + spec.n_head_kv]
    return _slopes_on(spec.n_head, spec.n_head_kv, spec.alibi_bias_max,
                      torch.device(device))


@functools.lru_cache(maxsize=16)
def _slopes_on(n_head: int, n_head_kv: int, bias_max: float,
               device: torch.device) -> torch.Tensor:
    return alibi_slopes(n_head, bias_max, device).reshape(
        n_head_kv, n_head // n_head_kv)


def _attention_batched(
    spec: ModelSpec,
    layer: LayerParams,
    a: torch.Tensor,  # [B, T, E] normed input
    positions: torch.Tensor,  # [B, T] absolute
    n_past: torch.Tensor,  # [B] on a's device
    k_cache,  # ([B, H_kv, S, D] codes, [B, H_kv, S] scale | None)
    v_cache,
    online_pass=None,  # callable qf -> (m, l, acc): cached-KV attention
    #                    done elsewhere (the dense or paged kernel); one
    #                    with `wants_kv` set is called (qf, kf, vf)
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
        if getattr(online_pass, "wants_kv", False):
            m, l, acc = online_pass(qf, kf, vf)
        elif online_pass is not None:
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

    tp = _tp(spec)
    if tp is not None and tp.attn and not tp.wo_split:
        out = tp.gather(out)  # every head, for the whole wo
    out = qmatmul(out, layer.wo)
    if tp is not None and tp.attn and tp.wo_split:
        out = tp.reduce(out)  # the partial sums of the rank's heads
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
                        n_past: torch.Tensor, write_mask=None) -> KVCache:
    """Write the new K/V rows [B, T, H, D] of every layer (or (codes,
    scales) when int8) into the cache in place, at each stream's own
    position n_past [B] (an int tensor on the cache's device): one indexed
    write per cache tensor, all layers and streams at once. Like the
    reference's dynamic_update_slice, a start that would run past the end
    is clamped to S - T.

    `write_mask` [B] (a bool tensor on the cache's device, or host bools):
    a stream with False writes its own current rows back, as the
    reference's predicated update does, so one captured step serves any
    mask the buffer holds."""
    quantized = cache.k_scale is not None
    B, S = cache.k.shape[1], cache.k.shape[3]
    if quantized:
        pairs = ((cache.k, [kn[0] for kn in k_news]),
                 (cache.v, [vn[0] for vn in v_news]),
                 (cache.k_scale, [kn[1] for kn in k_news]),
                 (cache.v_scale, [vn[1] for vn in v_news]))
    else:
        pairs = ((cache.k, k_news), (cache.v, v_news))
    T = k_news[0][0].shape[1] if quantized else k_news[0].shape[1]
    dev = cache.k.device
    ar = torch.arange(T, dtype=torch.int64, device=dev)
    pos = torch.clamp(n_past.to(torch.int64), 0, S - T)[:, None] + ar
    bi = torch.arange(B, dtype=torch.int64, device=dev)[:, None].expand(B, T)
    mask = None
    if write_mask is not None:
        mask = torch.as_tensor(write_mask, dtype=torch.bool, device=dev)
    for dst, news in pairs:
        new = torch.stack(news).to(dst.dtype)  # [L, B, T, H(, D)]
        # the cache [L, B, H, S(, D)] seen position-major: (b, pos) index
        # two adjacent axes, and the rows take new's layout
        rows = dst.transpose(2, 3)
        if mask is not None:
            keep = mask.view((1, B) + (1,) * (new.dim() - 2))
            new = torch.where(keep, new, rows[:, bi, pos])
        rows[:, bi, pos] = new
    return cache


def embed_batched(spec: ModelSpec, params: ModelParams, ids, positions):
    """[B, T] ids -> [B, T, E] f32 embeddings (+ post-embed norm / learned
    positions per spec)."""
    B, T = ids.shape
    h = quant_rows_lookup(params.wte, ids.reshape(-1)).reshape(B, T, -1)
    if spec.post_embed_norm:
        h = layer_norm(h, params.emb_norm_w, params.emb_norm_b)
    if spec.learned_pos:
        # the reference's gather clamps a position past the table to its
        # last row (the loader caps n_ctx at the table's height, so only a
        # masked stream's dummy position can get there)
        pos = positions.reshape(-1).clamp(0, params.wpe.shape[-1] - 1)
        h = h + quant_rows_lookup(params.wpe, pos).reshape(B, T, -1)
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
    tp = _tp(local_spec(spec, params))
    if tp is not None and tp.vocab:
        logits = tp.gather(logits)  # the vocabulary shards, in rank order
    return (logits.reshape(B, T, -1).to(torch.float32),
            h.to(torch.float32))


def forward_batched(
    spec: ModelSpec,
    params: ModelParams,
    ids: torch.Tensor,  # [B, T] int
    n_past: Union[Sequence[int], torch.Tensor],  # [B]
    cache: KVCache,  # [L, B, H_kv, S, D]
    window: Optional[int] = None,
    write_mask=None,  # [B] bool: host bools or a tensor on the device
):
    """Batched forward over B independent streams sharing the weights.

    Returns (logits [B, T, V] f32, hidden [B, T, E] f32, cache), the cache
    updated in place. `n_past`: host ints, or an int32 tensor on the
    cache's device, which the step reads without a host sync (the decode
    graph's form). `window` bounds cache reads and must cover max(n_past);
    `write_mask` (default all True) keeps the cache rows of masked streams
    as they are."""
    spec = local_spec(spec, params)
    dev = cache.k.device
    ids = torch.as_tensor(ids, device=dev)
    B, T = ids.shape
    if isinstance(n_past, torch.Tensor):
        npast = n_past.to(device=dev, dtype=torch.int32)
    else:
        npast = torch.tensor([int(p) for p in n_past], dtype=torch.int32,
                             device=dev)
    tp = _tp(spec)
    split = tp is not None and cache.k.shape[1] != B
    if split:
        # the cache holds this rank's `data` block of the B streams
        # (shard_cache(batched=True)): run those rows, gather the rest
        rows = tp.data_rows(B, cache.k.shape[1])
        ids, npast = ids[rows], npast[rows]
        if write_mask is not None:
            write_mask = write_mask[rows]
    positions = npast[:, None] + torch.arange(T, dtype=torch.int32,
                                              device=dev)[None, :]
    h = embed_batched(spec, params, ids, positions)

    W = cache.k.shape[3] if window is None else min(window, cache.k.shape[3])
    h, k_news, v_news = run_layers_batched(spec, params.layers, h, positions,
                                           npast, cache, W)
    write_cache_batched(cache, k_news, v_news, npast, write_mask)
    logits, h = head_batched(spec, params, h)
    if split:  # every stream's rows on every rank, in one gather
        V = logits.shape[-1]
        both = tp.gather_rows(torch.cat([logits, h], dim=-1))
        logits, h = both[..., :V], both[..., V:]
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
    if isinstance(n_past, torch.Tensor):
        n_past = n_past.cpu().numpy()
    past = int(np.max(np.asarray(n_past)))
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


@torch.no_grad()
def nll_step(spec, params, ids, targets, valid, n_past, cache, window=None):
    """Evaluate `ids` at n_past and return (summed NLL of `targets` at the
    `valid` positions as a 0-d f32 tensor on the cache's device, cache):
    the perplexity inner loop, with the log-softmax and the gather on the
    device so that no [T, n_vocab] logits cross to the host."""
    _check_window(window, n_past, extra=len(ids))
    logits, _, cache = forward(spec, params, ids, n_past, cache, window)
    dev = logits.device
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    targets = torch.as_tensor(targets, device=dev).to(torch.int64)
    valid = torch.as_tensor(valid, device=dev)
    tok_logp = logp.gather(1, targets[:, None])[:, 0]
    return -torch.where(valid, tok_logp, 0.0).sum(), cache


def window_bucket(n_past: int, n_ctx: int, granule: int = 512) -> int:
    """Read-window bucket covering n_past: multiples of `granule` (bounded
    by n_ctx), so decode cache traffic tracks the actual context length."""
    if n_ctx <= granule:
        return n_ctx
    w = ((max(n_past, 1) + granule - 1) // granule) * granule
    return min(n_ctx, max(w, granule))


# ---------------------------------------------------------------------------
# the on-device decode loops


_WARMUPS = 2  # eager steps on the capture stream before a capture
_MAX_GRAPHS = 8  # decode graphs kept per cache or pool; the oldest goes


@dataclass(eq=False)
class DecodeGraph:
    """One captured T=1 decode step over one cache (or page pool) and its
    static buffers (`state`): for one stream (`decode_loop`) logits [V],
    npast [1], the step index [1], the tokens and the mu after each step
    [cap], the penalty window and mu, and the uniforms [cap, V]; for B
    streams (`decode_loop_batched`, `paged.paged_decode_loop`) the same
    with a leading [B] (tokens [cap, B], uniforms [cap, B, V]), plus the
    per-stream sampler values, the write mask or the page tables and the
    block's rows, and the logprob outputs. A replay reads and writes only
    these, the weights and the cache."""

    state: dict = field(repr=False)
    bias: Optional[torch.Tensor] = field(repr=False)  # the flat bias [V]
    params: object = field(repr=False)  # the weights the graph points at
    graph: object = None  # torch.cuda.CUDAGraph, once captured
    capture_s: float = 0.0  # host seconds of the capture itself
    pool_bytes: int = 0  # device memory the capture reserved
    # kernel launches one replay makes, as the wrappers counted them while
    # the step was captured (they count calls, so they never see a replay)
    launches: dict = field(default_factory=dict)
    replays: int = 0


def _capacity(n_steps: int) -> int:
    """A graph's block capacity: n_steps rounded up to a power of two, so
    a shorter block reuses the graph of its capacity."""
    return 1 << (n_steps - 1).bit_length()


def _shapes(tree: Optional[dict]) -> tuple:
    """(name, shape) of each tensor of a state or value dict: the part of
    a graph's key that its buffers' shapes depend on."""
    return tuple((k, tuple(torch.as_tensor(v).shape))
                 for k, v in sorted((tree or {}).items()))


def _draws(sampler) -> bool:
    """Whether the sampler takes noise (else it never reads uniforms)."""
    if isinstance(sampler, BatchedDeviceSampler):
        return sampler.sample
    return sampler.kind != "greedy"


def _block_uniforms(sampler, uniforms, key: Optional[torch.Generator],
                    shape: tuple, dev) -> Optional[torch.Tensor]:
    """A block's uniforms in [1e-20, 1) (None when the sampler takes no
    noise): `uniforms` when given, which must have `shape`, else drawn
    from `key` (None: a generator of seed 0 on `dev`)."""
    if not _draws(sampler):
        return None
    if uniforms is not None:
        u = torch.as_tensor(uniforms, dtype=torch.float32).to(dev)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms {tuple(u.shape)}, expected "
                             f"{tuple(shape)}")
        return u
    if key is None:
        key = torch.Generator(device=dev)
        key.manual_seed(0)
    # the reference's uniform(minval=1e-20, maxval=1.0)
    return torch.rand(shape, generator=key, device=dev).clamp_min_(1e-20)


def _step_state(spec, sampler, penalty_state, has_mu: bool, cap: int,
                dev) -> dict:
    """The static buffers of a single-stream decode step (DecodeGraph)."""
    V = spec.n_vocab
    st = {
        "logits": torch.zeros(V, dtype=torch.float32, device=dev),
        "npast": torch.zeros(1, dtype=torch.int32, device=dev),
        "i": torch.zeros(1, dtype=torch.int64, device=dev),
        "toks": torch.zeros(cap, dtype=torch.int32, device=dev),
    }
    if sampler.kind != "greedy":
        st["u"] = torch.full((cap, V), 0.5, dtype=torch.float32, device=dev)
    for k, v in (penalty_state or {}).items():
        st[k] = (torch.zeros((), dtype=torch.float32, device=dev) if k == "mu"
                 else torch.zeros_like(torch.as_tensor(v), device=dev))
    if has_mu:
        st["mu_steps"] = torch.zeros(cap, dtype=torch.float32, device=dev)
    return st


def _load_state(st: dict, last_logits, n_past: int, penalty_state,
                u: Optional[torch.Tensor]) -> None:
    """Copy a single-stream block's inputs into the static buffers."""
    st["logits"].copy_(torch.as_tensor(last_logits, dtype=torch.float32))
    st["npast"].fill_(n_past)
    st["i"].zero_()
    for k, v in (penalty_state or {}).items():
        st[k].copy_(torch.as_tensor(v))
    if u is not None:
        st["u"][: u.shape[0]].copy_(u)


_PENALTY_KEYS = ("counts", "ring", "pos", "mu")


def _decode_step(spec, params, cache: KVCache, window: int, sampler,
                 st: dict, bias) -> None:
    """One token, on the buffers of `st` in place: sample from the logits
    with the step's uniforms, evaluate the token at npast, store it (and
    mu) at the step index, advance both. No host sync and no host copy:
    the graph captures exactly this."""
    i = st["i"]
    u = st["u"].index_select(0, i)[0] if "u" in st else None
    pst = {k: st[k] for k in _PENALTY_KEYS if k in st} or None
    tok, pst = device_sample_step(st["logits"], u, sampler, pst, bias)
    logits, _, _ = forward_batched(spec, params, tok.view(1, 1), st["npast"],
                                   cache, window)
    st["logits"].copy_(logits[0, -1])
    st["toks"].index_copy_(0, i, tok.view(1))
    if "mu_steps" in st:
        st["mu_steps"].index_copy_(0, i, pst["mu"].view(1))
    for k, v in (pst or {}).items():
        st[k].copy_(v)
    st["npast"].add_(1)
    i.add_(1)


def _launch_counts() -> dict:
    return {"qmatmul": qmatmul_mod.LAUNCHES,
            "dense_attention": dense_attention.LAUNCHES,
            "paged_attention": paged_attention.LAUNCHES}


def _capture(g: DecodeGraph, dev, step) -> None:
    """Warm `step` (one decode step, or one forward, over g.state) up
    eagerly on a side stream (builds and loads the kernels, sizes the
    attention workspace of that stream at the step's own shapes), then
    capture one step on it. Each warm-up is a first step: the step index
    and npast go back to their loaded values. A dense cache's warm-up
    writes its rows at npast, which no read sees before the first replay
    overwrites them; a paged step writes only the block's rows. Raises if
    the capture fails: there is no eager fallback on the card. The whole
    of it is the `graph.capture` span; `g.capture_s` times the capture
    alone."""
    with trace.span("graph.capture"):
        st = g.state
        # the buffers a step advances (a forward graph has no step index)
        loaded = {k: st[k].clone() for k in ("i", "npast") if k in st}
        s = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            for _ in range(_WARMUPS):
                for k, v in loaded.items():
                    st[k].copy_(v)
                step()
        torch.cuda.current_stream(dev).wait_stream(s)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _launch_counts()
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            step()
        torch.cuda.synchronize(dev)
        g.capture_s = time.monotonic() - t0
        g.launches = {k: v - before[k] for k, v in _launch_counts().items()}
        g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        g.graph = graph


def _graph_entry(graphs: dict, key, make) -> DecodeGraph:
    """The graph of `key` in `graphs` (a cache's or a pool's), made by
    make() (not yet captured) when missing; the most recently used come
    last, and past _MAX_GRAPHS the least recently used goes."""
    g = graphs.pop(key, None)
    if g is None:
        g = make()
        while len(graphs) >= _MAX_GRAPHS:
            graphs.pop(next(iter(graphs)))
    graphs[key] = g
    return g


def _graph_for(spec, params, cache: KVCache, window: int, sampler,
               penalty_state, has_mu: bool, n_steps: int) -> DecodeGraph:
    """The cache's single-stream decode graph for this static key (window,
    sampler, the penalty state's shapes, mu trajectory, capacity)."""
    cap = _capacity(n_steps)
    key = (id(params), window, sampler, _shapes(penalty_state), has_mu, cap)
    dev = cache.k.device
    return _graph_entry(cache.graphs, key, lambda: DecodeGraph(
        _step_state(spec, sampler, penalty_state, has_mu, cap, dev),
        bias_vector(sampler, spec.n_vocab, dev), params))


# graphs asked for on the card that ran eagerly because the weights are
# tensor-parallel: a captured step would hold the collectives of a world
EAGER_UNDER_MESH = 0


def _graph_ok(graph: bool, params, dev) -> bool:
    """`graph`, but False for tensor-parallel weights: such a step runs
    eagerly, and where it would have been captured (on the card) that is
    counted in EAGER_UNDER_MESH."""
    global EAGER_UNDER_MESH
    if graph and getattr(params, "tp", None) is not None:
        EAGER_UNDER_MESH += torch.device(dev).type == "cuda"
        return False
    return graph


def _on_card(graph: bool, dev) -> bool:
    """Whether a loop runs its step as a captured graph: asked for, on a
    CUDA device (the CPU always runs it eagerly)."""
    return graph and torch.device(dev).type == "cuda"


def _run_block(g: DecodeGraph, step, load, n_steps: int, graph: bool,
               dev) -> dict:
    """Run n_steps decode steps over g.state, its buffers loaded by
    load(state): with `graph`, replays of g's graph (captured at its first
    block); else `step` eagerly. Returns the state."""
    st = g.state
    if graph:
        if g.graph is None:
            load(st)
            _capture(g, dev, step)
        load(st)
        for _ in range(n_steps):
            g.graph.replay()
        g.replays += n_steps
    else:
        load(st)
        for _ in range(n_steps):
            step()
    return st


@torch.no_grad()
def forward_replay(spec, params, ids, n_past, cache: KVCache, window: int,
                   write_mask=None, graph: bool = True) -> torch.Tensor:
    """`forward_batched`'s logits [B, T, V] of ids [B, T] at n_past [B]
    over the dense cache (updated in place): the speculative verify (T=k)
    and the T=1 evaluations of bonus and tail tokens.

    On the card the forward is a CUDA graph captured at the first call
    with this cache and static key (`cache.graphs`: the weights, B, T, the
    window, the cache's dtype, whether a write mask is given) and replayed:
    ids, n_past and the mask go into its static buffers first (device to
    device where they already lie on the card), and the replay does not
    sync with the host. `graph=False` runs the same forward eagerly there
    (the CPU always does). Returns a copy of the logits."""
    dev = cache.k.device
    ids = torch.as_tensor(ids, device=dev)
    B, T = ids.shape
    W = min(window, cache.k.shape[3])
    _check_window(W, n_past)
    if not _on_card(_graph_ok(graph, params, dev), dev):
        return forward_batched(spec, params, ids, n_past, cache, W,
                               write_mask)[0]
    masked = write_mask is not None
    key = ("forward", id(params), B, T, W, cache.k.dtype, masked)

    def make():
        st = {"ids": torch.zeros((B, T), dtype=torch.int64, device=dev),
              "npast": torch.zeros(B, dtype=torch.int32, device=dev),
              "logits": torch.zeros((B, T, spec.n_vocab),
                                    dtype=torch.float32, device=dev)}
        if masked:
            st["mask"] = torch.zeros(B, dtype=torch.bool, device=dev)
        return DecodeGraph(st, None, params)

    g = _graph_entry(cache.graphs, key, make)
    st = g.state

    def step():
        st["logits"].copy_(forward_batched(spec, params, st["ids"],
                                           st["npast"], cache, W,
                                           st.get("mask"))[0])

    def load(st):
        st["ids"].copy_(ids)
        st["npast"].copy_(torch.as_tensor(n_past, dtype=torch.int32))
        if masked:
            st["mask"].copy_(torch.as_tensor(write_mask, dtype=torch.bool))

    _run_block(g, step, load, 1, True, dev)
    return st["logits"].clone()


@torch.no_grad()
def decode_loop(spec, params, last_logits, n_past, cache: KVCache,
                n_steps: int, window: Optional[int] = None, sampler=None,
                key: Optional[torch.Generator] = None, penalty_state=None,
                return_state: bool = False,
                uniforms: Optional[torch.Tensor] = None, graph: bool = True):
    """Generate `n_steps` tokens on the device: per step, sample from the
    current logits, evaluate the token, take its logits (the reference's
    `decode_loop`, one dispatch). The host reads the tokens once a block.

    Returns (tokens [n_steps] int32, final logits [V] f32, new n_past (an
    int32 tensor), cache); with `return_state` also the sampler state, with
    `mu_steps` [n_steps] (mu after each step) when it carries mirostat's
    "mu". The host checks the tokens for EoT and rewinds n_past past any
    overshoot (cache rows at and past n_past are masked). `window` must
    cover n_past + n_steps.

    `sampler`: a DeviceSampler (None: greedy). `key`: the torch.Generator,
    on the cache's device, that the block's uniforms [n_steps, V] are drawn
    from (None: seed 0); `uniforms` hands them over instead. On the card
    the step runs as a CUDA graph, captured at the first call with this
    cache and static key (`cache.graphs`) and replayed once a token;
    `graph=False` runs the same step eagerly there (the CPU always does).
    """
    n_past = int(n_past)
    _check_window(window, n_past, extra=n_steps)
    sampler = sampler or DeviceSampler.greedy()
    dev = cache.k.device
    S = cache.k.shape[3]
    W = S if window is None else min(window, S)
    has_mu = (return_state and isinstance(penalty_state, dict)
              and "mu" in penalty_state)
    u = _block_uniforms(sampler, uniforms, key, (n_steps, spec.n_vocab), dev)
    on_card = _on_card(_graph_ok(graph, params, dev), dev)
    if on_card:
        g = _graph_for(spec, params, cache, W, sampler, penalty_state, has_mu,
                       n_steps)
    else:
        g = DecodeGraph(
            _step_state(spec, sampler, penalty_state, has_mu, n_steps, dev),
            bias_vector(sampler, spec.n_vocab, dev), params)
    st = _run_block(
        g, lambda: _decode_step(spec, params, cache, W, sampler, g.state,
                                g.bias),
        lambda st: _load_state(st, last_logits, n_past, penalty_state, u),
        n_steps, on_card, dev)
    toks = st["toks"][:n_steps].clone()
    out = (toks, st["logits"].clone(), st["npast"][0].clone(), cache)
    if not return_state:
        return out
    pst = {k: st[k].clone() for k in _PENALTY_KEYS if k in st}
    if has_mu:
        pst["mu_steps"] = st["mu_steps"][:n_steps].clone()
    return (*out, pst)


# -- B streams a step -------------------------------------------------------


def batched_state(spec, B: int, sampler, values: Optional[dict],
                  penalty_state: Optional[dict], has_mu: bool,
                  logprobs_n: Optional[int], cap: int, dev) -> dict:
    """The static buffers of a batched decode step (DecodeGraph) common to
    the dense and the paged loop."""
    V = spec.n_vocab
    f32 = torch.float32
    st = {
        "logits": torch.zeros((B, V), dtype=f32, device=dev),
        "npast": torch.zeros(B, dtype=torch.int32, device=dev),
        "i": torch.zeros(1, dtype=torch.int64, device=dev),
        "toks": torch.zeros((cap, B), dtype=torch.int32, device=dev),
    }
    if _draws(sampler):
        st["u"] = torch.full((cap, B, V), 0.5, dtype=f32, device=dev)
    for k, v in (penalty_state or {}).items():
        v = torch.as_tensor(v)
        st[k] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
    if has_mu:
        st["mu_steps"] = torch.zeros((cap, B), dtype=f32, device=dev)
    for k, v in (values or {}).items():
        st["v_" + k] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
    if logprobs_n is not None:
        n = max(logprobs_n, 1)
        st["lp"] = torch.zeros((cap, B), dtype=f32, device=dev)
        st["topv"] = torch.zeros((cap, B, n), dtype=f32, device=dev)
        st["topi"] = torch.zeros((cap, B, n), dtype=torch.int64, device=dev)
    return st


def load_batched(st: dict, last_logits, n_past, penalty_state, values,
                 u: Optional[torch.Tensor]) -> None:
    """Copy a block's inputs into the static buffers: one copy a tensor."""
    st["logits"].copy_(torch.as_tensor(last_logits, dtype=torch.float32))
    st["npast"].copy_(torch.as_tensor(n_past))
    st["i"].zero_()
    for k, v in (penalty_state or {}).items():
        st[k].copy_(torch.as_tensor(v))
    for k, v in (values or {}).items():
        st["v_" + k].copy_(v)
    if u is not None:
        st["u"][: u.shape[0]].copy_(u)


def batched_step(st: dict, sampler, bias, forward) -> None:
    """One token for every stream, on the buffers of `st` in place: sample
    from the logits [B, V] with the step's uniforms (the same draw for the
    Gumbel and the mirostat pick), gather the sampled token's logprob and
    the top-N from the same row (the reference's pre-update definition),
    forward(tokens [B], step index) -> the next logits [B, V], store the
    tokens (and mu) at the step index, advance npast and the index. No
    host sync and no host copy: the graph captures exactly this."""
    i = st["i"]
    logits = st["logits"]
    u = st["u"].index_select(0, i)[0] if "u" in st else None
    pst = {k: st[k] for k in _PENALTY_KEYS if k in st} or None
    values = {k[2:]: v for k, v in st.items() if k.startswith("v_")} or None
    tok, pst = device_sample_step(logits, u, sampler, pst, bias, values)
    if "lp" in st:
        logz = torch.log_softmax(logits, dim=-1)
        st["lp"].index_copy_(0, i, logz.gather(1, tok[:, None].long()).T)
        topv, topi = torch.topk(logz, st["topv"].shape[-1], dim=-1)
        st["topv"].index_copy_(0, i, topv[None])
        st["topi"].index_copy_(0, i, topi[None])
    st["logits"].copy_(forward(tok, i))
    st["toks"].index_copy_(0, i, tok[None])
    if "mu_steps" in st:
        st["mu_steps"].index_copy_(0, i, pst["mu"][None])
    for k, v in (pst or {}).items():
        st[k].copy_(v)
    st["npast"].add_(1)
    i.add_(1)


def batched_out(st: dict, n_steps: int, cache, penalty_state,
                return_state: bool, logprobs_n: Optional[int]) -> tuple:
    """The reference's return of a batched loop: (tokens [n_steps, B],
    final logits [B, V], n_past [B], cache[, sampler state][, (logprobs
    [n_steps, B], top-N values and ids [n_steps, B, N])]), copies of the
    buffers."""
    out = [st["toks"][:n_steps].clone(), st["logits"].clone(),
           st["npast"].clone(), cache]
    if return_state:
        pst = None
        if penalty_state is not None:
            pst = {k: st[k].clone() for k in _PENALTY_KEYS if k in st}
            if "mu_steps" in st:
                pst["mu_steps"] = st["mu_steps"][:n_steps].clone()
        out.append(pst)
    if logprobs_n is not None:
        out.append(tuple(st[k][:n_steps].clone()
                         for k in ("lp", "topv", "topi")))
    return tuple(out)


def batched_graph(graphs: dict, key: tuple, spec, params, B: int, sampler,
                  values, penalty_state, has_mu: bool, logprobs_n, n_steps,
                  dev, on_card: bool, extra) -> DecodeGraph:
    """The batched step's DecodeGraph: on the card the one of `graphs` for
    `key` plus the static structure (B, sampler, the shapes of the values
    and penalty state, mu, logprobs, capacity); eagerly a fresh one.
    extra(state) adds the loop's own buffers."""
    cap = _capacity(n_steps)

    def make():
        st = batched_state(spec, B, sampler, values, penalty_state, has_mu,
                           logprobs_n, cap, dev)
        extra(st)
        bias = (bias_vector(sampler, spec.n_vocab, dev)
                if isinstance(sampler, DeviceSampler) else None)
        return DecodeGraph(st, bias, params)

    if not on_card:
        return make()
    key = key + (id(params), B, sampler, _shapes(values),
                 _shapes(penalty_state), has_mu, logprobs_n, cap)
    return _graph_entry(graphs, key, make)


@torch.no_grad()
def decode_loop_batched(spec, params, last_logits, n_past, cache: KVCache,
                        n_steps: int, window: Optional[int] = None,
                        sampler=None, key: Optional[torch.Generator] = None,
                        sampler_values: Optional[dict] = None,
                        write_mask=None, penalty_state: Optional[dict] = None,
                        logprobs_n: Optional[int] = None,
                        return_state: bool = False,
                        uniforms: Optional[torch.Tensor] = None,
                        graph: bool = True):
    """B streams x `n_steps` tokens on the device over the dense cache
    (the reference's `decode_loop_batched`): per step, sample every
    stream's token from its logits, evaluate the tokens at T=1, take the
    next logits. `window` must cover max(n_past) + n_steps.

    Returns (tokens [n_steps, B] int32, final logits [B, V] f32, n_past
    [B] int32, cache); with `return_state` then the sampler state (its
    `mu_steps` [n_steps, B] the mu after each step), with `logprobs_n`
    last the sampled tokens' logprobs [n_steps, B] and the top-N values
    and ids [n_steps, B, N] of each step's pre-update row
    (`unpack_decode_out` reads the tail).

    `sampler`: a DeviceSampler shared by every stream (None: greedy), or a
    BatchedDeviceSampler with its per-stream `sampler_values`.
    `write_mask` [B] bool: a masked stream (a dummy slot) keeps its cache
    rows. `key` / `uniforms`: as for `decode_loop`, uniforms [n_steps, B,
    V]. On the card the step runs as a CUDA graph captured once per
    static key (`cache.graphs`: window, B, the sampler's structure, the
    values' and penalty state's shapes, mu, logprobs_n, capacity): a
    block loads logits, n_past, mask, values, penalty state, mu and
    uniforms into its buffers, then replays it once a token. `graph=False`
    runs the same step eagerly there (the CPU always does)."""
    _check_window(window, n_past, extra=n_steps)
    sampler = sampler or DeviceSampler.greedy()
    dev = cache.k.device
    B, S = last_logits.shape[0], cache.k.shape[3]
    W = S if window is None else min(window, S)
    has_mu = (return_state and isinstance(penalty_state, dict)
              and "mu" in penalty_state)
    u = _block_uniforms(sampler, uniforms, key, (n_steps, B, spec.n_vocab),
                        dev)
    mask = (torch.ones(B, dtype=torch.bool) if write_mask is None
            else torch.as_tensor(write_mask, dtype=torch.bool))
    on_card = _on_card(_graph_ok(graph, params, dev), dev)

    def extra(st):
        st["mask"] = torch.zeros(B, dtype=torch.bool, device=dev)

    g = batched_graph(cache.graphs, ("dense", W), spec, params, B, sampler,
                      sampler_values, penalty_state, has_mu, logprobs_n,
                      n_steps, dev, on_card, extra)
    st = g.state

    def step():
        batched_step(st, sampler, g.bias, lambda tok, i: forward_batched(
            spec, params, tok[:, None], st["npast"], cache, W,
            st["mask"])[0][:, 0])

    def load(st):
        load_batched(st, last_logits, n_past, penalty_state, sampler_values,
                     u)
        st["mask"].copy_(mask)

    _run_block(g, step, load, n_steps, on_card, dev)
    return batched_out(st, n_steps, cache, penalty_state, return_state,
                       logprobs_n)


def unpack_decode_out(out, return_state: bool, logprobs_n):
    """The one reader of a decode loop's variadic tail, (toks, logits,
    n_past, cache[, sampler state][, logprob arrays]): returns the
    6-tuple with None for an absent extra."""
    out = list(out)
    toks, logits, npast, cache = out[:4]
    rest = out[4:]
    fstate = rest.pop(0) if return_state else None
    lp = rest.pop(0) if logprobs_n is not None else None
    return toks, logits, npast, cache, fstate, lp
