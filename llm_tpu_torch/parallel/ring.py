"""Ring-attention sequence-parallel prefill (context parallelism).

The counterpart of `llm_tpu/parallel/ring.py`. A long prompt's prefill
shards over a `seq` mesh axis of n ranks: each rank holds a contiguous
chunk of T/n tokens, computes its own Q/K/V, and the K/V blocks rotate
around the ring (n - 1 rotations of paired non-blocking sends and
receives, `sharding.sendrecv`) while every rank folds them into the
online-softmax state of its own queries. Attention over T tokens then
takes O(T/n) activation memory a rank and only neighbour-to-neighbour
traffic.

Causality falls out of absolute positions: a block from a later rank
masks to nothing (a finite -1e30 keeps the state free of NaN), and each
rank's in-chunk causal term is the ordinary path of
`models/forward._attention_batched`, whose `online_pass` hook the ring
fills (marked `wants_kv`, so it receives the local K/V to rotate).

The weights are whole on every rank of the ring. At the end the K/V of
every layer are gathered over `seq` into a whole cache on every rank, and
the last rank's head logits of the last position are broadcast.
"""

from __future__ import annotations

import torch

from llm_tpu_torch.models.forward import (
    _layer_batched,
    _quant_kv,
    _slopes,
    embed_batched,
    head_batched,
    init_cache_batched,
    write_cache_batched,
)
from llm_tpu_torch.loader import resolve_device
from llm_tpu_torch.models.spec import ModelSpec
from llm_tpu_torch.parallel.sharding import (
    Mesh,
    all_gather,
    broadcast,
    sendrecv,
)

NEG_INF = -1e30


def make_seq_mesh(n: int | None = None, device=None,
                  axis: str = "seq") -> Mesh:
    """A 1-D mesh whose only axis is the sequence-parallel ring (n: the
    world size, which is the default)."""
    import torch.distributed as dist

    if n is None:
        if not dist.is_initialized():
            raise RuntimeError("make_seq_mesh needs an initialized process "
                               "group")
        n = dist.get_world_size()
    return Mesh((axis,), (n,), resolve_device(device))


def _ring_pass(spec: ModelSpec, mesh: Mesh, axis: str, tl: int):
    """online_pass hook: rotate (kf, vf) around `axis` n - 1 times,
    accumulating the online-softmax state of the local queries against
    every other rank's block. The local block stays with the caller."""
    n = mesh.shape[axis]
    my = mesh.coords[axis]
    nxt = mesh.rank_at(**{axis: (my + 1) % n})
    prv = mesh.rank_at(**{axis: (my - 1) % n})

    def ring(qf, kf, vf):
        # qf [B, Tl, Hkv, rep, D] f32; kf/vf [B, Tl, Hkv, D] f32
        B, Tl, Hkv, rep, D = qf.shape
        dev = qf.device
        slopes = _slopes(spec, dev)
        ar = torch.arange(tl, dtype=torch.int32, device=dev)
        q_pos = my * tl + ar
        m = torch.full((B, Tl, Hkv, rep), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Tl, Hkv, rep), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Tl, Hkv, rep, D), dtype=torch.float32,
                          device=dev)
        kv = torch.stack([kf, vf])  # one message a rotation
        for s in range(1, n):
            kv_in = torch.empty_like(kv)
            sendrecv(mesh, send=kv, dst=nxt, recv=kv_in, src=prv)
            kv = kv_in
            kb, vb = kv[0], kv[1]
            src = (my - s) % n
            k_pos = src * tl + ar
            sn = torch.einsum("bthrd,buhd->bthru", qf, kb) * spec.kq_scale
            if slopes is not None:
                sn = sn + (slopes[None, None, :, :, None]
                           * k_pos.to(torch.float32)[None, None, None, None,
                                                     :])
            valid = k_pos[None, :] <= q_pos[:, None]  # [Tl, Tl] causal
            cv = valid[None, :, None, None, :]
            sn = torch.where(cv, sn, NEG_INF)
            m2 = torch.maximum(m, sn.amax(dim=-1))
            p = torch.where(cv, torch.exp(sn - m2[..., None]), 0.0)
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bthru,buhd->bthrd",
                                                       p, vb)
            m = m2
        return m, l, acc

    ring.wants_kv = True
    return ring


@torch.no_grad()
def ring_prefill(
    spec: ModelSpec,
    params,
    ids,  # [B, T]; T divisible by the seq axis's size
    mesh: Mesh,
    axis: str = "seq",
    kv_dtype=torch.bfloat16,
):
    """Whole-prompt sequence-parallel prefill. Returns (last_logits [B, V],
    cache) with all T positions written, the same on every rank: decode
    continues on the ordinary batched path with n_past = T."""
    ids = torch.as_tensor(ids)
    B, T = ids.shape
    n = mesh.shape[axis]
    assert T % n == 0, (T, n)
    assert T <= spec.n_ctx, (T, spec.n_ctx)
    assert set(mesh.axis_names) == {axis}, (
        "ring prefill shards only the seq axis; run TP/DP decode on a "
        "separate mesh"
    )
    dev = mesh.device
    tl = T // n
    my = mesh.coords[axis]
    positions = (my * tl + torch.arange(tl, dtype=torch.int32, device=dev)
                 )[None, :].expand(B, tl)
    base = positions[:, 0].contiguous()  # [B] this chunk's first position
    h = embed_batched(spec, params, ids[:, my * tl:(my + 1) * tl].to(dev),
                      positions)
    ring = _ring_pass(spec, mesh, axis, tl)
    k_news, v_news = [], []
    for l in range(spec.n_layer):
        h, k_new, v_new = _layer_batched(
            spec, h, params.layers.layer(l), positions, base, (None, None),
            (None, None), online_pass=ring)
        k_news.append(k_new)
        v_news.append(v_new)
    # every rank's chunk of every layer's K/V: [L, B, T, Hkv, D]
    k_all = all_gather(torch.stack(k_news), mesh, axis, dim=2)
    v_all = all_gather(torch.stack(v_news), mesh, axis, dim=2)

    logits = torch.empty((B, spec.n_vocab), dtype=torch.float32, device=dev)
    if my == n - 1:
        logits.copy_(head_batched(spec, params, h[:, -1:, :])[0][:, 0])
    broadcast(logits, mesh, axis, n - 1)

    cache = init_cache_batched(spec, B, kv_dtype, dev)
    if cache.k_scale is not None:
        k_list = [_quant_kv(k) for k in k_all]
        v_list = [_quant_kv(v) for v in v_all]
    else:
        k_list, v_list = list(k_all), list(v_all)
    write_cache_batched(cache, k_list, v_list,
                        torch.zeros(B, dtype=torch.int32, device=dev))
    return logits, cache
