"""Pipeline parallelism: GPipe microbatching over a `pipe` mesh axis.

The counterpart of `llm_tpu/parallel/pipeline.py`. The stacked layer
weights make stage splitting mechanical: stage s of S holds layers
[s L/S, (s+1) L/S) and that run's slice of the KV cache
(`shard_params_pipeline`, `shard_cache_pipeline`). Each rank is one
process, so its compute is ordinary single-device code (K1 and K2 run on
it as they are), and activations go from stage to stage with send and
receive.

Schedule (GPipe, inference only): the batch B splits into M microbatches
of B/M streams; over S + M - 1 steps, stage s runs microbatch t - s at
step t and sends its activations to stage s + 1. Stage 0 embeds; the last
stage runs the head and broadcasts the logits and hidden over its `pipe`
group. A step in a fill or drain bubble does nothing: no stage computes
on garbage, so a microbatch's cache write mask is `valid & caller_mask`
with `valid` true. A chain of blocking sends and receives has no cycle,
so it cannot deadlock.

An optional `data` axis composes: the streams split over `data` (each
data row runs its own pipeline over the same stages); every rank returns
its data row's rows of the result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from llm_tpu_torch.models.forward import (
    KVCache,
    _check_window,
    embed_batched,
    head_batched,
    run_layers_batched,
    write_cache_batched,
)
from llm_tpu_torch.models.params import LayerParams, ModelParams
from llm_tpu_torch.ops.packing import QuantTensor, QuantTensorC
from llm_tpu_torch.loader import resolve_device
from llm_tpu_torch.parallel.sharding import Mesh, broadcast, sendrecv


def make_pipeline_mesh(pipe: int, data: int = 1, device=None) -> Mesh:
    """A ("data", "pipe") mesh over the process group (data * pipe
    ranks); `pipe` is the number of stages."""
    return Mesh(("data", "pipe"), (data, pipe), resolve_device(device))


def _stages(mesh: Mesh) -> int:
    return mesh.shape["pipe"]


def _layer_slice(w, lo: int, hi: int):
    if w is None:
        return None
    if isinstance(w, QuantTensor):
        def sl(p):
            return None if p is None else p[lo:hi].contiguous()

        return QuantTensor(w.fmt_name, w.k, w.r, sl(w.lo), sl(w.hi),
                           sl(w.scale), sl(w.bias), w.splits)
    if isinstance(w, QuantTensorC):
        return dataclasses.replace(w, buf=w.buf[lo:hi].contiguous())
    return w[lo:hi].contiguous()


def shard_params_pipeline(params: ModelParams, mesh: Mesh) -> ModelParams:
    """This rank's stage of the stacked layers (its run of L/S layers);
    the embedding, head and norms are whole on every rank."""
    S = _stages(mesh)
    L = params.layers.ln1_w.shape[0]
    assert L % S == 0, (
        f"n_layer={L} must divide evenly into {S} pipeline stages"
    )
    s = mesh.coords["pipe"]
    lo, hi = s * L // S, (s + 1) * L // S
    layers = LayerParams(**{
        f.name: _layer_slice(getattr(params.layers, f.name), lo, hi)
        for f in dataclasses.fields(LayerParams)})
    return dataclasses.replace(params, layers=layers)


def shard_cache_pipeline(cache: KVCache, mesh: Mesh) -> KVCache:
    """This rank's slice of a [L, B, H_kv, S, D] head-major cache: its
    stage's layers, and its `data` row's streams."""
    S, d = _stages(mesh), mesh.shape["data"]
    L, B = cache.k.shape[0], cache.k.shape[1]
    s, di = mesh.coords["pipe"], mesh.coords["data"]

    def sl(t):
        if t is None:
            return None
        t = t[s * L // S:(s + 1) * L // S, di * B // d:(di + 1) * B // d]
        return t.to(mesh.device).contiguous().clone()

    return KVCache(k=sl(cache.k), v=sl(cache.v), k_scale=sl(cache.k_scale),
                   v_scale=sl(cache.v_scale))


def _rows(cache: KVCache, lo: int, hi: int) -> KVCache:
    """Streams [lo, hi) of a cache: views (each layer's rows contiguous)."""
    def sl(t):
        return None if t is None else t[:, lo:hi]

    return KVCache(k=sl(cache.k), v=sl(cache.v), k_scale=sl(cache.k_scale),
                   v_scale=sl(cache.v_scale))


@torch.no_grad()
def pipeline_forward_batched(
    spec,
    params: ModelParams,  # this rank's stage (shard_params_pipeline)
    ids,  # [B, T] int
    n_past,  # [B] int
    cache: KVCache,  # this rank's [L/S, B/data, H_kv, S, D] slice
    mesh: Mesh,
    n_microbatches: int,
    window: Optional[int] = None,
    write_mask=None,  # [B] bool
):
    """forward_batched semantics, pipelined over `pipe` stages. Returns
    this rank's data row's (logits [B/data, T, V] f32, hidden [B/data, T,
    E] f32, cache), the cache slice updated in place; equal to
    forward_batched's rows up to the products' summation order."""
    ids = torch.as_tensor(ids)
    B, T = ids.shape
    M = n_microbatches
    S = _stages(mesh)
    L = spec.n_layer
    assert B % M == 0, f"batch {B} must divide into {M} microbatches"
    assert L % S == 0, f"n_layer {L} must divide into {S} stages"
    data = mesh.shape.get("data", 1)
    mb = B // M
    assert mb % data == 0, (
        f"microbatch size {mb} must divide over data={data}"
    )
    dev = mesh.device
    s, di = mesh.coords["pipe"], mesh.coords["data"]
    Bl, mbl = B // data, mb // data
    # the rank's streams: its data row's block of the batch; microbatch m
    # is rows [m * mbl, (m + 1) * mbl) of that block (the cache's order)
    rows = slice(di * Bl, (di + 1) * Bl)
    ids_l = ids[rows].to(dev)
    past_l = torch.as_tensor(n_past, dtype=torch.int32)[rows].to(dev)
    wm_l = (torch.ones(Bl, dtype=torch.bool) if write_mask is None
            else torch.as_tensor(write_mask, dtype=torch.bool)[rows]).to(dev)
    positions = past_l[:, None] + torch.arange(T, dtype=torch.int32,
                                               device=dev)[None, :]
    W = cache.k.shape[3] if window is None else min(window, cache.k.shape[3])
    E = spec.n_embd
    prev = mesh.rank_at(pipe=s - 1) if s > 0 else None
    nxt = mesh.rank_at(pipe=s + 1) if s < S - 1 else None
    outs = torch.zeros((Bl, T, E), dtype=torch.float32, device=dev)
    for t in range(S + M - 1):
        m = t - s
        valid = 0 <= m < M
        if not valid:
            continue  # a bubble: this stage has no microbatch at step t
        r = slice(m * mbl, (m + 1) * mbl)
        if s == 0:
            h = embed_batched(spec, params, ids_l[r], positions[r])
        else:
            h = torch.empty((mbl, T, E), dtype=torch.float32, device=dev)
            sendrecv(mesh, recv=h, src=prev)
        part = _rows(cache, m * mbl, (m + 1) * mbl)
        h, k_news, v_news = run_layers_batched(
            spec, params.layers, h, positions[r], past_l[r], part, W)
        write_cache_batched(part, k_news, v_news, past_l[r],
                            wm_l[r] & valid)
        if nxt is not None:
            sendrecv(mesh, send=h, dst=nxt)
        else:
            outs[r] = h
    V = spec.n_vocab
    logits = torch.empty((Bl, T, V), dtype=torch.float32, device=dev)
    hidden = torch.empty((Bl, T, E), dtype=torch.float32, device=dev)
    if s == S - 1:
        lg, hd = head_batched(spec, params, outs)
        logits.copy_(lg)
        hidden.copy_(hd)
    broadcast(logits, mesh, "pipe", S - 1)
    broadcast(hidden, mesh, "pipe", S - 1)
    return logits, hidden, cache


def pipeline_step(spec, params, ids, n_past, cache, mesh, n_microbatches,
                  window=None):
    """The pipeline forward with the window checked; the cache slice is
    updated in place."""
    _check_window(window, n_past, extra=torch.as_tensor(ids).shape[1])
    return pipeline_forward_batched(spec, params, ids, n_past, cache, mesh,
                                    n_microbatches, window)
