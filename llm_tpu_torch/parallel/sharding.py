"""Tensor and data parallelism on torch.distributed.

The counterpart of `llm_tpu/parallel/sharding.py`. Where the JAX package
annotates shardings and lets XLA's partitioner insert the collectives,
each rank here is one process that holds its own slices and runs ordinary
single-device code (K1, K2 and K4 included) between explicit collectives,
Megatron style.

Mesh: `make_mesh(MeshConfig(data, model))` over an initialized process
group of exactly data*model ranks; rank r sits at (r // model, r %
model), the row-major order of the JAX package's mesh. It builds one
process group for each `model` row and one for each `data` column.

    data  - replicates the weights and splits the streams of a batched
            step (`batched_forward_step`, `shard_cache(batched=True)`)
            and of the engines' dense caches
    model - tensor parallelism over heads, FFN columns and vocabulary rows

Sharding (`shard_params`), by units, never by a plane's own divisibility:
    q|k|v : a kv head with its query heads, when the mesh divides n_head_kv
    wo    : its rows of the rank's heads, when that row count is a whole
            number of the format's blocks (`_k_ok`); then the rank's
            partial products are summed over `model` before `bo`. Else wo
            stays whole and the heads' outputs are gathered before it.
    gate|up, down : FFN columns and down's rows, when the mesh divides
            n_ff and the rows are whole blocks; the partial sums are summed
            over `model` before `b_down`. Else the FFN stays whole.
    lm_head : vocabulary rows when the mesh divides n_vocab and the head
            is not tied; the logits' shards are gathered over `model`.
    the rest (embeddings, norms, `bo`, `b_down`) : replicated
After slicing, each rank fuses its own q|k|v and gate|up again, so a
rank's forward launches K1 as often as the single-card forward does.
A group that does not shard is whole on every rank, and skips its
collective. The dense KV cache shards over kv heads by the same rule
(`shard_cache`), and the paged engine's pool holds the rank's heads.

Collectives (`all_reduce`, `all_gather`, `broadcast`, `sendrecv`) run on
the process group's backend, which the caller names. Over gloo with
CUDA tensors, the ops gloo does not take on the card (GLOO_HOST_STAGED)
are staged through host copies. Every op is noted for
`collectives_audit.audit_step`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from llm_tpu_torch.loader import resolve_device
from llm_tpu_torch.models.forward import KVCache, forward_batched
from llm_tpu_torch.models.params import (
    LayerParams,
    ModelParams,
    fuse_layer_weights,
    unfuse_layer_weights,
)
from llm_tpu_torch.models.spec import ModelSpec, ShardSpec
from llm_tpu_torch.ops.packing import QuantTensor, QuantTensorC, uncoalesce_qt
from llm_tpu_torch.ops.qmatmul import BK, BN
from llm_tpu_torch.parallel import collectives_audit

# the collectives that gloo does not run on CUDA tensors (it runs
# all_reduce and broadcast there): staged through host copies
GLOO_HOST_STAGED = frozenset({"all_gather", "sendrecv"})


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1


class Mesh:
    """A rank's place in a mesh of processes: `axis_names`, `shape` (axis
    -> size), `devices` (the global ranks as an array of the mesh's shape),
    this rank's `coords` (axis -> index), its process group and the group's
    ranks along each axis, the torch `device` of its tensors and the
    process group's `backend`. Every rank must build the same meshes in
    the same order (each builds every group)."""

    def __init__(self, axis_names, sizes, device):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs an initialized torch.distributed process group "
                f"of {int(np.prod(sizes))} ranks (parallel/launch.spawn)")
        world, rank = dist.get_world_size(), dist.get_rank()
        n = int(np.prod(sizes))
        if world != n:
            raise ValueError(f"a {dict(zip(axis_names, sizes))} mesh needs "
                             f"{n} ranks; the process group has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.devices = np.arange(n).reshape(tuple(sizes))
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank,
                                                                 sizes))))
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.groups: dict = {}
        self.group_ranks: dict = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(-1, sizes[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)  # every rank, same order
                if rank in ranks:
                    self.groups[name] = group
                    self.group_ranks[name] = ranks

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with `coords`
        replaced."""
        c = dict(self.coords, **coords)
        return int(self.devices[tuple(c[a] for a in self.axis_names)])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords},"
                f" {self.backend}, {self.device})")


def make_mesh(config: Optional[MeshConfig] = None, device=None) -> Mesh:
    """A ("data", "model") mesh over the initialized process group, whose
    world size must be data*model (default: one row of the whole world).
    `device` is this rank's torch device (default: the card)."""
    if config is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialized process group")
        config = MeshConfig(data=1, model=dist.get_world_size())
    return Mesh(("data", "model"), (config.data, config.model),
                resolve_device(device))


# -- collectives ------------------------------------------------------------


def _staged(mesh: Mesh, op: str, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda and op in GLOO_HOST_STAGED


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum x over `axis` (in place); returns x."""
    collectives_audit.note("all-reduce", mesh, mesh.group_ranks[axis],
                           x.numel() * x.element_size(),
                           f"all_reduce {tuple(x.shape)} {x.dtype}")
    dist.all_reduce(x, group=mesh.groups[axis])
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = -1) -> torch.Tensor:
    """The ranks' x along `axis`, concatenated on `dim` in rank order."""
    n = mesh.shape[axis]
    collectives_audit.note("all-gather", mesh, mesh.group_ranks[axis],
                           n * x.numel() * x.element_size(),
                           f"all_gather {tuple(x.shape)} {x.dtype}")
    src = x.contiguous()
    if _staged(mesh, "all_gather", src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str,
              src_index: int) -> torch.Tensor:
    """x from the rank at index `src_index` along `axis`, on every rank of
    the group (in place); returns x."""
    ranks = mesh.group_ranks[axis]
    collectives_audit.note("broadcast", mesh, ranks,
                           x.numel() * x.element_size(),
                           f"broadcast {tuple(x.shape)} {x.dtype}")
    dist.broadcast(x, src=ranks[src_index], group=mesh.groups[axis])
    return x


def sendrecv(mesh: Mesh, send: Optional[torch.Tensor] = None,
             dst: Optional[int] = None, recv: Optional[torch.Tensor] = None,
             src: Optional[int] = None) -> None:
    """Send `send` to global rank `dst` and receive into `recv` from
    global rank `src`, as one batch of paired non-blocking ops (either
    side may be absent), so that a ring of these does not deadlock."""
    if send is not None:
        collectives_audit.note("send-recv", mesh, [mesh.rank, dst],
                               send.numel() * send.element_size(),
                               f"send {tuple(send.shape)} {send.dtype}")
    probe = send if send is not None else recv
    staged = _staged(mesh, "sendrecv", probe)
    s = send.contiguous() if send is not None else None
    r = recv
    if staged:
        s = s.cpu() if s is not None else None
        r = torch.empty(recv.shape, dtype=recv.dtype) if recv is not None \
            else None
    ops = []
    if s is not None:
        ops.append(dist.P2POp(dist.isend, s, dst))
    if r is not None:
        ops.append(dist.P2POp(dist.irecv, r, src))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged and recv is not None:
        recv.copy_(r)


# -- the rank's tensor-parallel view ----------------------------------------


@dataclass(eq=False)
class TensorParallel:
    """Which layer groups a rank holds a shard of, and the collectives of
    its `model` row (the forward's hooks, models/forward.py)."""

    mesh: Mesh
    attn: bool  # q|k|v hold the rank's heads
    wo_split: bool  # wo holds their rows: reduce after; else gather before
    ffn: bool  # gate|up columns and down rows: reduce after down
    vocab: bool  # lm_head rows: gather the logits
    n_head: int  # the rank's query heads
    n_head_kv: int  # and kv heads
    kv_start: int  # its first kv head
    _views: dict = dataclasses.field(default_factory=dict, repr=False)

    def view(self, spec: ModelSpec) -> ShardSpec:
        """The rank's ShardSpec of the model's `spec` (one per spec)."""
        v = self._views.get(spec)
        if v is None:
            base = {f.name: getattr(spec, f.name)
                    for f in dataclasses.fields(ModelSpec)}
            base.update(n_head=self.n_head, n_head_kv=self.n_head_kv)
            v = ShardSpec(**base, n_head_global=spec.n_head,
                          n_head_kv_global=spec.n_head_kv,
                          kv_start=self.kv_start, tp=self)
            self._views[spec] = v
        return v

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.mesh, "model")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, self.mesh, "model", dim=-1)

    def data_rows(self, n: int, n_local: int) -> slice:
        """This rank's rows of a batch of n streams whose cache holds
        n_local of them: its block along `data`."""
        if n_local * self.mesh.shape["data"] != n:
            raise ValueError(f"a cache of {n_local} streams a rank is not "
                             f"a {self.mesh.shape['data']}-way split of {n}")
        i = self.mesh.coords["data"]
        return slice(i * n_local, (i + 1) * n_local)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The `data` blocks of x [n_local, ...], concatenated in order."""
        return all_gather(x, self.mesh, "data", dim=0)

    def broadcast_rows(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """x from the rank at `index` along `data` (in place)."""
        return broadcast(x, self.mesh, "data", index)


@dataclass
class ShardedParams(ModelParams):
    """A rank's slices of a model's parameters, with its TensorParallel
    handle; every forward over them runs the sharded forward."""

    tp: Optional[TensorParallel] = None


def _planes(w):
    return uncoalesce_qt(w) if isinstance(w, QuantTensorC) else w


def _pad_cols(p: torch.Tensor, rp: int) -> torch.Tensor:
    out = torch.zeros(p.shape[:-1] + (rp,), dtype=p.dtype, device=p.device)
    out[..., :p.shape[-1]] = p
    return out


def _cols(w, start: int, stop: int):
    """Output columns [start, stop) of a (layer-stacked) weight, padded
    back to whole 128-column blocks (padded scales are 0)."""
    if w is None:
        return None
    w = _planes(w)
    if isinstance(w, QuantTensor):
        rp = -(-(stop - start) // BN) * BN

        def sl(p):
            return None if p is None else _pad_cols(p[..., start:stop], rp)

        return QuantTensor(w.fmt_name, w.k, stop - start, sl(w.lo), sl(w.hi),
                           sl(w.scale), sl(w.bias))
    return w[..., start:stop].contiguous()


def _k_unit(w) -> int:
    """The rows a K slice of `w` must be a whole number of: the format's
    blocks (256 for the K-quants; two scale groups for formats whose f16
    scales pair up in a word) and the kernel's 64-row stage. 1 for a dense
    weight."""
    w = _planes(w)
    if not isinstance(w, QuantTensor):
        return 1
    fmt = w.fmt
    unit = 256 if fmt.name.endswith("_k") else fmt.gsize
    if w.scale_packed:
        unit = max(unit, 2 * fmt.gsize)
    return max(unit, BK)


def _k_ok(w, k_local: int) -> bool:
    return k_local % _k_unit(w) == 0


def _rows(w, start: int, stop: int):
    """Input rows [start, stop) of a (layer-stacked) weight; both must be
    whole units (`_k_unit`)."""
    if w is None:
        return None
    w = _planes(w)
    if isinstance(w, QuantTensor):
        fmt, g = w.fmt, w.fmt.gsize

        def sl(p, per_row):
            if p is None:
                return None
            return p[..., int(start * per_row):int(stop * per_row), :] \
                .contiguous()

        lo_per = 1 if fmt.lo_bits == 8 else fmt.lo_bits / 32
        s_per = 1 / (2 * g) if w.scale_packed else 1 / g
        return QuantTensor(w.fmt_name, stop - start, w.r, sl(w.lo, lo_per),
                           sl(w.hi, fmt.hi_bits / 32), sl(w.scale, s_per),
                           sl(w.bias, s_per))
    return w[..., start:stop, :].contiguous()


def _vec(v, start: int, stop: int):
    return None if v is None else v[..., start:stop].contiguous()


def shard_params(params: ModelParams, mesh: Mesh,
                 spec: ModelSpec) -> ShardedParams:
    """This rank's slices of `params` (every rank holds the whole model
    and takes its own): see the module docstring for the rules. Unlike
    the JAX package's, it takes the model's spec: slicing by heads needs
    the head counts, which the weights alone do not tell."""
    m, i = mesh.shape["model"], mesh.coords["model"]
    L = unfuse_layer_weights(params.layers)
    H, Hkv, D = spec.n_head, spec.n_head_kv, spec.head_dim

    attn = Hkv % m == 0
    Hl, Hkvl = (H // m, Hkv // m) if attn else (H, Hkv)
    wo_split = attn and _k_ok(L.wo, Hl * D)
    kw = {}
    if attn:
        q0, q1 = i * Hl * D, (i + 1) * Hl * D
        k0, k1 = i * Hkvl * D, (i + 1) * Hkvl * D
        kw.update(wq=_cols(L.wq, q0, q1), bq=_vec(L.bq, q0, q1),
                  wk=_cols(L.wk, k0, k1), bk=_vec(L.bk, k0, k1),
                  wv=_cols(L.wv, k0, k1), bv=_vec(L.bv, k0, k1))
        if wo_split:
            kw["wo"] = _rows(L.wo, q0, q1)

    F = L.w_up.shape[-1] if isinstance(L.w_up, torch.Tensor) else L.w_up.r
    ffn = F % m == 0 and _k_ok(L.w_down, F // m)
    if ffn:
        f0, f1 = i * F // m, (i + 1) * F // m
        kw.update(w_up=_cols(L.w_up, f0, f1), b_up=_vec(L.b_up, f0, f1),
                  w_gate=_cols(L.w_gate, f0, f1),
                  w_down=_rows(L.w_down, f0, f1))
    layers = fuse_layer_weights(dataclasses.replace(L, **kw))

    head = params.lm_head
    V = spec.n_vocab
    vocab = head is not None and V % m == 0
    top = {}
    if vocab:
        v0, v1 = i * V // m, (i + 1) * V // m
        top.update(lm_head=_cols(head, v0, v1),
                   lm_head_b=_vec(params.lm_head_b, v0, v1))
    tp = TensorParallel(mesh, attn, wo_split, ffn, vocab, Hl, Hkvl,
                        i * Hkvl if attn else 0)
    base = {f.name: getattr(params, f.name)
            for f in dataclasses.fields(ModelParams)}
    base.update(top, layers=layers)
    return ShardedParams(**base, tp=tp)


def local_streams(mesh: Mesh, n: int) -> int:
    """The streams of n that a rank's batched cache holds: its block along
    `data` when `data` divides n (the rule of `shard_cache(batched=True)`),
    else all n."""
    d = mesh.shape["data"]
    return n // d if n % d == 0 else n


def _slice_dim(t: Optional[torch.Tensor], dim: int, parts: int,
               index: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


def shard_cache(cache: KVCache, mesh: Mesh, batched: bool = False) -> KVCache:
    """This rank's slice of a dense head-major cache [L, B, H_kv, S, D]:
    its kv heads when the mesh's `model` divides H_kv (the rule under
    which `shard_params` shards attention), and with `batched` its
    streams when `data` divides B. On the mesh's device; a fresh copy."""
    m, d = mesh.shape["model"], mesh.shape["data"]
    Bn, Hkv = cache.k.shape[1], cache.k.shape[2]

    def sl(t):
        if t is None:
            return None
        if Hkv % m == 0:
            t = _slice_dim(t, 2, m, mesh.coords["model"])
        if batched and local_streams(mesh, Bn) != Bn:
            t = _slice_dim(t, 1, d, mesh.coords["data"])
        return t.to(mesh.device).contiguous().clone()

    return KVCache(k=sl(cache.k), v=sl(cache.v), k_scale=sl(cache.k_scale),
                   v_scale=sl(cache.v_scale))


@torch.no_grad()
def batched_forward_step(spec, params: ShardedParams, ids, n_past,
                         cache: KVCache):
    """Data-parallel decode over (ids [B, T], n_past [B]) with this rank's
    shard of the cache (`shard_cache(batched=True)`): the rank runs the
    streams of its `data` index with its `model` slices and returns their
    rows of (logits [B/data, T, V] f32, hidden, cache). No collective
    crosses `data`."""
    mesh = params.tp.mesh
    ids = torch.as_tensor(ids)
    B, Bl = ids.shape[0], cache.k.shape[1]
    if Bl != B:
        rows = slice(mesh.coords["data"] * Bl, (mesh.coords["data"] + 1) * Bl)
        ids = ids[rows]
        n_past = torch.as_tensor(n_past)[rows]
    return forward_batched(spec, params, ids, n_past, cache)
