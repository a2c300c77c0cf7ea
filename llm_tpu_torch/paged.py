"""Paged KV cache: a shared page pool with per-stream page tables.

The counterpart of `llm_tpu/paged.py`. Streams allocate fixed-size pages
from a shared pool as their context grows and release them when they
finish, so KV memory tracks the tokens in flight, not max_streams x n_ctx.

Layout, as the reference's (layer-major; heads above positions):

    pool.k/v          [L, n_pages, H_kv, page, D]   (bf16/f32 or int8 codes)
                      [L, n_pages, H_kv, page, D/2] uint8 (planar int4 codes)
    pool.k/v_scale    [L, n_pages, H_kv, page] f32  (int8 and int4 pools)
    page_table        [B, P] int32 physical page ids (logical order)

Attention reads pages in logical order with an online softmax (the
`online_pass` hook of models/forward._attention_batched): decode steps
(T=1) through `ops/paged_attention.paged_attention_pass` (the hand-written
kernel on the card), prefill chunks through its plain page loop. Unlike the
reference's pure functions, the pool is updated in place: `scatter_rows`
writes each new (token, head) row into its page slot.

`paged_decode_loop` decodes a block of n_steps tokens for every stream on
the device: the rows a block writes stay in a step-major block buffer
(`_fold_block_rows` folds them after the pool pass) and reach the pool in
one `scatter_rows` at the end of the block. On the card its T=1 step is a
captured CUDA graph (`PagedKVCache.graphs`), replayed once a token.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from llm_tpu_torch.models.forward import (
    NEG_INF,
    _block_uniforms,
    _graph_ok,
    _layer_batched,
    _on_card,
    _run_block,
    _slopes,
    batched_graph,
    batched_out,
    batched_step,
    embed_batched,
    head_batched,
    load_batched,
    local_spec,
    unpack_decode_out,
)
from llm_tpu_torch.models.spec import ModelSpec
from llm_tpu_torch.ops.packing import pack_int4_rows
from llm_tpu_torch.ops.paged_attention import (
    paged_attention_pass,
    paged_attention_plain,
)
from llm_tpu_torch.ops.sampling import DeviceSampler
from llm_tpu_torch.serve import Engine, _chunk_bucket


@dataclass
class PagedKVCache:
    """The page pool. `graphs` holds the decode-step CUDA graphs captured
    over it (`paged_decode_loop`), which hold its tensors' addresses."""

    k: torch.Tensor  # [L, n_pages, H_kv, page, D] (uint8 [.., D/2]: int4)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, n_pages, H_kv, page] f32
    v_scale: Optional[torch.Tensor] = None
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def bits(self) -> Optional[int]:
        """Quantized pool width: 8 (int8 codes), 4 (planar nibble-packed
        uint8, ops/packing.pack_int4_rows layout), None (bf16/f32)."""
        if self.k_scale is None:
            return None
        return 4 if self.k.dtype == torch.uint8 else 8

    @property
    def qmax(self) -> Optional[float]:
        """Code range of the quantized pool (scale = amax / qmax)."""
        bits = self.bits
        return None if bits is None else (7.0 if bits == 4 else 127.0)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)


def init_paged_cache(spec: ModelSpec, n_pages: int, page_size: int = 256,
                     dtype=torch.bfloat16, device=None) -> PagedKVCache:
    """A zeroed pool; dtype is torch.bfloat16, torch.float32, "int8" or
    "int4"."""
    shape = (spec.n_layer, n_pages, spec.n_head_kv, page_size, spec.head_dim)
    if dtype == "int4":
        if spec.head_dim % 2:
            raise ValueError("int4 pools need an even head dim")
        packed = shape[:-1] + (spec.head_dim // 2,)
        codes, cdt = packed, torch.uint8
    elif dtype in (torch.int8, "int8"):
        codes, cdt = shape, torch.int8
    elif dtype in (torch.bfloat16, torch.float32):
        return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device))
    else:
        raise ValueError(f"paged pools take bf16/f32/int8/int4, not {dtype}")
    return PagedKVCache(
        k=torch.zeros(codes, dtype=cdt, device=device),
        v=torch.zeros(codes, dtype=cdt, device=device),
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    )


class PageAllocator:
    """Host-side free-list allocator over the physical pages.

    Physical page 0 is RESERVED as the trash page: unallocated page-table
    entries point at it, so dummy writes from inactive/boundary streams land
    somewhere harmless and reads of unallocated entries see masked
    garbage."""

    TRASH = 0

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least one real page beside the trash "
                             "page")
        self.free = list(range(n_pages - 1, 0, -1))

    def alloc(self, n: int = 1) -> list[int]:
        if len(self.free) < n:
            raise MemoryError("KV page pool exhausted")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        self.free.extend(int(p) for p in pages if int(p) != self.TRASH)

    @property
    def available(self) -> int:
        return len(self.free)


class PrefixCache:
    """Prompt-prefix KV reuse at page granularity (host bookkeeping copied
    from the reference).

    The KV rows of position p depend only on tokens[0..p], so a full page
    whose covering token prefix matches a new request's prompt is shared
    verbatim. Full prompt pages are registered here, content-addressed by a
    rolling SHA-256 over the token prefix; admission borrows the longest
    registered chain and starts prefill at the matched page boundary.

    Pages are refcounted by the number of page-table rows pointing at them;
    at refcount 0 they stay cached (LRU) and are evicted back to the free
    list only under pool pressure. Shared pages are never written: a borrow
    is a whole-page-aligned prefix no longer than the prompt, so every write
    of the borrowing stream lands in pages past the borrowed chain.
    """

    #: bound on cached last-token logits rows (host RAM: ~V floats each).
    LOGITS_CAP = 32

    def __init__(self):
        self.by_key: dict[bytes, int] = {}  # prefix digest -> page id
        self.key_of: dict[int, bytes] = {}
        self.refs: dict[int, int] = {}  # page id -> #table rows using it
        self.lru: dict[int, None] = {}  # refcount-0 pages, insertion-ordered
        # full-prompt digest -> last-token logits row (np [V]), LRU-bounded:
        # an exact page-aligned repeat skips prefill entirely
        self.logits_by_key: dict[bytes, np.ndarray] = {}

    @staticmethod
    def digests(tokens, page_size: int, n_pages: int) -> list[bytes]:
        """Rolling per-page-boundary digests: digests[j] covers
        tokens[: (j+1)*page_size]. One linear pass."""
        h = hashlib.sha256()
        out = []
        arr = np.asarray(tokens[: n_pages * page_size], np.int32)
        for j in range(n_pages):
            h.update(arr[j * page_size : (j + 1) * page_size].tobytes())
            out.append(h.digest())
        return out

    def register(self, digest: bytes, pid: int) -> None:
        """Register physical page `pid` under its covering-prefix digest.
        The registering stream holds the first reference. First
        registration wins."""
        if digest in self.by_key or pid in self.refs:
            return
        self.by_key[digest] = pid
        self.key_of[pid] = digest
        self.refs[pid] = 1

    def match(self, tokens, page_size: int) -> list[int]:
        """Longest registered chain of full pages covering a strict prefix
        of `tokens` (at least one token is always left to prefill).
        Takes references."""
        limit = (len(tokens) - 1) // page_size
        return self.match_digests(self.digests(tokens, page_size, limit))

    def match_digests(self, digests) -> list[int]:
        """match() on a precomputed digest chain."""
        chain: list[int] = []
        for d in digests:
            pid = self.by_key.get(d)
            if pid is None:
                break  # a chain with a hole is unusable past the hole
            chain.append(pid)
        for pid in chain:
            self.acquire(pid)
        return chain

    def register_logits(self, digest: bytes, row) -> None:
        """Cache the last-token logits of an exactly page-aligned prompt
        under its full-prompt digest (LRU-bounded at LOGITS_CAP rows)."""
        self.logits_by_key.pop(digest, None)
        self.logits_by_key[digest] = np.array(row, np.float32)
        while len(self.logits_by_key) > self.LOGITS_CAP:
            del self.logits_by_key[next(iter(self.logits_by_key))]

    def match_logits(self, digest: bytes):
        """Cached last-token logits for this exact prompt, or None. A hit
        refreshes LRU order; the caller gets a private copy."""
        row = self.logits_by_key.pop(digest, None)
        if row is None:
            return None
        self.logits_by_key[digest] = row
        return np.array(row)

    def acquire(self, pid: int) -> None:
        self.refs[pid] += 1
        self.lru.pop(pid, None)

    def dec(self, pid: int) -> None:
        """Drop one reference; at zero the page becomes evictable but stays
        cached until the allocator needs it."""
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self.lru[pid] = None

    def evict(self, n: int) -> list[int]:
        """Drop up to n least-recently-released refcount-0 pages from the
        cache, returning them for the free list."""
        out = []
        while self.lru and len(out) < n:
            pid = next(iter(self.lru))
            del self.lru[pid]
            del self.by_key[self.key_of.pop(pid)]
            del self.refs[pid]
            out.append(pid)
        return out

    @property
    def evictable(self) -> int:
        return len(self.lru)


def scatter_rows(cache: PagedKVCache, k_news, v_news, positions, tables):
    """Write new rows (k_news [L, B, T, H, D], or (codes, scales) for
    quantized pools) into their physical page slots at `positions` [B, T],
    in place. One indexed write per (token, head) row over the pool seen as
    [L, NP*Hkv, page(, D)].

    Positions whose logical page is beyond the table (dummy writes of
    inactive/boundary streams) go to the TRASH page: clamping them to the
    table's last column would corrupt the stream's live last page."""
    page = cache.page_size
    dev = cache.k.device
    positions = torch.as_tensor(positions, device=dev).long()
    tables = torch.as_tensor(tables, device=dev).long()
    P, Hkv = tables.shape[1], cache.k.shape[2]
    page_idx = positions // page  # [B, T]
    phys = torch.where(
        page_idx < P,
        torch.gather(tables, 1, page_idx.clamp(max=P - 1)),
        torch.full_like(page_idx, PageAllocator.TRASH),
    )
    rows = (phys.reshape(-1, 1) * Hkv
            + torch.arange(Hkv, device=dev)[None, :])  # [B*T, Hkv]
    offs = (positions % page).reshape(-1, 1).expand(rows.shape)

    def scatter(pool, new):
        # pool [L, NP, Hkv, page(, D)]; new [L, B, T, H(, D)]
        L, tail = pool.shape[0], pool.shape[4:]
        flat_pool = pool.view((L, -1, page) + tail)
        flat_new = new.reshape((L, -1, Hkv) + tail)
        flat_pool[:, rows, offs] = flat_new.to(pool.dtype)

    if cache.quantized:
        (kq, ks), (vq, vs) = k_news, v_news  # attention emits (codes, scales)
        if cache.bits == 4:  # planar-pack rows to the pool's nibble layout
            kq, vq = pack_int4_rows(kq), pack_int4_rows(vq)
        for pool, new in ((cache.k, kq), (cache.v, vq),
                          (cache.k_scale, ks), (cache.v_scale, vs)):
            scatter(pool, new)
    else:
        scatter(cache.k, k_news)
        scatter(cache.v, v_news)
    return cache


def _stack_news(news, quantized: bool):
    """Per-layer [B, T, H(, D)] rows (or (codes, scales)) -> [L, ...]."""
    if quantized:
        return (torch.stack([n[0] for n in news]),
                torch.stack([n[1] for n in news]))
    return torch.stack(news)


def _fold_block_rows(spec, blk_k, blk_v, blk_ks, blk_vs, base_past, n_past,
                     layer: int, slopes, qf, m, l, acc):
    """Fold a block's own rows into a running online softmax: the second
    fold of the block-buffered decode step, after the pool pass that
    covers positions < base_past. blk_k/v [S', L, B, Hkv, D] step-major
    (codes with blk_ks/vs [S', L, B, Hkv] scales, or rows), row j of
    stream b at position base_past[b] + j; rows at positions >= n_past[b]
    are masked. qf [B, T, Hkv, rep, D]; returns the new (m, l, acc)."""
    Sp = blk_k.shape[0]
    kf = blk_k[:, layer].to(torch.float32)  # [S', B, H, D]
    vf = blk_v[:, layer].to(torch.float32)
    if blk_ks is not None:
        kf = kf * blk_ks[:, layer][..., None]
        vf = vf * blk_vs[:, layer][..., None]
    s = torch.einsum("bthrd,sbhd->bthrs", qf, kf) * spec.kq_scale
    pos = base_past[:, None] + torch.arange(Sp, dtype=torch.int32,
                                            device=qf.device)[None, :]
    if slopes is not None:
        s = s + (slopes[None, None, :, :, None]
                 * pos.to(torch.float32)[:, None, None, None, :])
    valid = (pos < n_past[:, None])[:, None, None, None, :]  # [B,1,1,1,S']
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bthrs,sbhd->bthrd", p, vf)
    return m_new, l, acc


@torch.no_grad()
def paged_forward_batched(spec: ModelSpec, params, ids, n_past, tables,
                          cache: PagedKVCache, window_pages: int,
                          block_kv=None, return_rows: bool = False):
    """Batched forward over paged caches: ids [B, T], n_past [B], tables
    [B, P] physical page ids. Returns (logits [B, T, V] f32, hidden
    [B, T, E] f32, cache), the pool updated in place; with `return_rows`
    (logits, hidden, (k_news, v_news)) and the pool untouched, the new rows
    [L, B, T, H, D] (or (codes, scales)) for the caller to place.

    Every (n_past + t) write position must fall inside an allocated page of
    `tables` (or past the table, which goes to the trash page); reads only
    touch positions < n_past, so `window_pages` just needs to cover
    max(n_past) + T. T=1 steps read the pool through
    `paged_attention_pass`, longer chunks through its plain page loop.

    `block_kv` (blk_k, blk_v, blk_ks, blk_vs, base_past): the block-
    buffered decode step. The pool pass masks at the block's base
    positions base_past [B], and the block's rows at [base_past, n_past)
    fold in from the block buffer (`_fold_block_rows`)."""
    spec = local_spec(spec, params)
    dev = cache.k.device
    ids = torch.as_tensor(ids, device=dev)
    n_past = torch.as_tensor(n_past, device=dev).to(torch.int32)
    tables = torch.as_tensor(tables, device=dev).to(torch.int32)
    B, T = ids.shape
    positions = n_past[:, None] + torch.arange(T, dtype=torch.int32,
                                               device=dev)[None, :]
    pool_past = n_past if block_kv is None else block_kv[4]
    slopes = _slopes(spec, dev)
    h = embed_batched(spec, params, ids, positions)
    pool_pass = paged_attention_pass if T == 1 else paged_attention_plain
    k_news, v_news = [], []
    for l in range(spec.n_layer):
        online = functools.partial(
            pool_pass, spec, cache.k, cache.v, cache.k_scale, cache.v_scale,
            tables, pool_past, slopes, window_pages, l,
        )
        if block_kv is not None:
            online = functools.partial(_fold_after, online, spec, block_kv,
                                       n_past, l, slopes)
        # int4 pools quantize in-flight rows at qmax=7 so the scores seen
        # this step bit-match the codes the pool will hold
        h, k_new, v_new = _layer_batched(
            spec, h, params.layers.layer(l), positions, n_past, (None, None),
            (None, None), online_pass=online, qmax=cache.qmax,
        )
        k_news.append(k_new)
        v_news.append(v_new)
    k_news = _stack_news(k_news, cache.quantized)
    v_news = _stack_news(v_news, cache.quantized)
    logits, h = head_batched(spec, params, h)
    if return_rows:
        return logits, h, (k_news, v_news)
    scatter_rows(cache, k_news, v_news, positions, tables)
    return logits, h, cache


def _fold_after(pool_pass, spec, block_kv, n_past, layer, slopes, qf):
    """The block-buffered step's online pass: the pool below the block's
    base, then the block's rows."""
    blk_k, blk_v, blk_ks, blk_vs, base_past = block_kv
    m, l, acc = pool_pass(qf)
    return _fold_block_rows(spec, blk_k, blk_v, blk_ks, blk_vs, base_past,
                            n_past, layer, slopes, qf, m, l, acc)


def _block_buffers(spec, cache: PagedKVCache, B: int, cap: int, dev) -> dict:
    """The block buffer of a paged decode step, step-major [cap, L, B, Hkv,
    D]: the pool's rows, or int8 codes (int4 pools keep them unpacked
    until the end-of-block scatter packs them) with f32 scales."""
    shape = (cap, spec.n_layer, B, spec.n_head_kv, spec.head_dim)
    kdt = torch.int8 if cache.bits == 4 else cache.k.dtype
    st = {"blk_k": torch.zeros(shape, dtype=kdt, device=dev),
          "blk_v": torch.zeros(shape, dtype=kdt, device=dev)}
    if cache.quantized:
        st["blk_ks"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
        st["blk_vs"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)
    return st


def _store_block_rows(st: dict, i: torch.Tensor, k_new, v_new) -> None:
    """Write one step's rows ([L, B, 1, H(, D)], or (codes, scales)) at
    step index i of the block buffer: one copy a buffer."""
    if "blk_ks" in st:
        (kq, ksc), (vq, vsc) = k_new, v_new
        pairs = (("blk_k", kq), ("blk_v", vq), ("blk_ks", ksc),
                 ("blk_vs", vsc))
    else:
        pairs = (("blk_k", k_new), ("blk_v", v_new))
    for name, new in pairs:
        dst = st[name]
        dst.index_copy_(0, i, new[:, :, 0][None].to(dst.dtype))


@torch.no_grad()
def paged_decode_loop(spec, params, last_logits, n_past, tables,
                      cache: PagedKVCache, n_steps: int, window_pages: int,
                      sampler=None, key: Optional[torch.Generator] = None,
                      sampler_values: Optional[dict] = None,
                      penalty_state: Optional[dict] = None,
                      logprobs_n: Optional[int] = None,
                      return_state: bool = False,
                      uniforms: Optional[torch.Tensor] = None,
                      graph: bool = True):
    """B streams x `n_steps` tokens on the device over the page pool (the
    reference's `paged_decode_loop`): per step, sample every stream's token,
    evaluate the tokens at T=1, take the next logits. The host allocates
    pages covering n_past + n_steps of every live stream first, so the
    tables hold for the whole block; it rewinds n_past past an EoT (rows at
    and past n_past stay masked).

    The rows a step writes go to a step-major block buffer [cap, L, B, Hkv,
    D] (int8 codes for int4 pools); during the block the pool pass masks at
    the block's base positions and the block's rows fold in after it; one
    `scatter_rows` writes the block's n_steps rows of every stream to the
    pool after the last step. Returns what `forward.decode_loop_batched`
    returns, the pool in place of the cache; its arguments are the same,
    with the tables [B, P] and `window_pages` (covering max(n_past) +
    n_steps) in place of the window and mask. On the card the step is a CUDA
    graph captured once per static key (`cache.graphs`: window_pages, B,
    the table width, the sampler's structure, the values' and penalty
    state's shapes, mu, logprobs_n, capacity), its tables, base positions
    and the other inputs loaded into its buffers before the replays."""
    spec = local_spec(spec, params)
    dev = cache.k.device
    n_past = torch.as_tensor(n_past).to(torch.int32)
    tables = torch.as_tensor(tables).to(torch.int32)
    B, P = tables.shape
    sampler = sampler or DeviceSampler.greedy()
    has_mu = (return_state and isinstance(penalty_state, dict)
              and "mu" in penalty_state)
    u = _block_uniforms(sampler, uniforms, key, (n_steps, B, spec.n_vocab),
                        dev)
    on_card = _on_card(_graph_ok(graph, params, dev), dev)

    def extra(st):
        st["tables"] = torch.zeros((B, P), dtype=torch.int32, device=dev)
        st["base"] = torch.zeros(B, dtype=torch.int32, device=dev)
        st.update(_block_buffers(spec, cache, B, st["toks"].shape[0], dev))

    g = batched_graph(cache.graphs, ("paged", window_pages, P), spec, params,
                      B, sampler, sampler_values, penalty_state, has_mu,
                      logprobs_n, n_steps, dev, on_card, extra)
    st = g.state
    block_kv = (st["blk_k"], st["blk_v"], st.get("blk_ks"), st.get("blk_vs"),
                st["base"])

    def forward(tok, i):
        logits, _, (k_new, v_new) = paged_forward_batched(
            spec, params, tok[:, None], st["npast"], st["tables"], cache,
            window_pages, block_kv=block_kv, return_rows=True)
        _store_block_rows(st, i, k_new, v_new)
        return logits[:, 0]

    def load(st):
        load_batched(st, last_logits, n_past, penalty_state, sampler_values,
                     u)
        st["tables"].copy_(tables)
        st["base"].copy_(n_past)

    _run_block(g, lambda: batched_step(st, sampler, g.bias, forward), load,
               n_steps, on_card, dev)
    # the end-of-block flush: one scatter of the block's rows
    positions = st["base"][:, None] + torch.arange(
        n_steps, dtype=torch.int32, device=dev)[None, :]

    def to_lbt(a):  # [n, L, B, ..] -> [L, B, n, ..]
        return a[:n_steps].movedim(0, 2)

    if cache.quantized:
        scatter_rows(cache, (to_lbt(st["blk_k"]), to_lbt(st["blk_ks"])),
                     (to_lbt(st["blk_v"]), to_lbt(st["blk_vs"])), positions,
                     st["tables"])
    else:
        scatter_rows(cache, to_lbt(st["blk_k"]), to_lbt(st["blk_v"]),
                     positions, st["tables"])
    return batched_out(st, n_steps, cache, penalty_state, return_state,
                       logprobs_n)


def _copy_page(pool: PagedKVCache, src: int, dst: int) -> None:
    """Copy one physical page's rows (all layers, K+V+scales) src -> dst in
    place: the prefix cache's copy-on-write tail."""
    for a in (pool.k, pool.v, pool.k_scale, pool.v_scale):
        if a is not None:
            a[:, dst] = a[:, src]


# ---------------------------------------------------------------------------
# paged continuous-batching engine


class PagedEngine(Engine):
    """Continuous batching over a shared page pool.

    Same host contract as serve.Engine (submit/step/generate_all, sampler
    chains, retirement events), but KV memory is pooled: total pages bound
    the tokens in flight rather than max_streams x n_ctx.
    """

    def __init__(
        self,
        model,
        max_streams: int = 8,
        page_size: int = 256,
        n_pages: Optional[int] = None,
        kv_dtype=torch.bfloat16,
        n_batch: int = 64,
        prefix_cache: bool = False,
        mesh=None,
    ):
        self.page_size = page_size
        self._n_pages_requested = n_pages
        self.prefix_cache = PrefixCache() if prefix_cache else None
        self.decode_dispatches = 0  # batched T=1 forwards run by step()
        super().__init__(model, max_streams, kv_dtype, n_batch, mesh=mesh)

    def _init_device_state(self, kv_dtype) -> None:
        self.pages_per_stream = -(-self.spec.n_ctx // self.page_size)
        n_pages = self._n_pages_requested
        if n_pages is None:
            # default: every stream can reach full context (+1 trash page)
            n_pages = 1 + self.max_streams * self.pages_per_stream
        # under a mesh, a pool of the rank's own kv heads: each layer's
        # pages are contiguous, as K4 needs
        self.pool = init_paged_cache(local_spec(self.spec, self.params),
                                     n_pages, self.page_size, kv_dtype,
                                     self.device)
        self.allocator = PageAllocator(n_pages)
        self.tables = np.full(
            (self.max_streams, self.pages_per_stream),
            PageAllocator.TRASH,
            np.int32,
        )
        self.stream_pages: list[list[int]] = [
            [] for _ in range(self.max_streams)
        ]

    # -- paging -------------------------------------------------------------

    def _alloc(self, n: int = 1) -> list[int]:
        """Allocate from the free list, evicting refcount-0 prefix-cache
        pages under pressure."""
        if self.prefix_cache is not None:
            short = n - self.allocator.available
            if short > 0:
                self.allocator.release(self.prefix_cache.evict(short))
        return self.allocator.alloc(n)

    def _ensure_pages(self, slot: int, upto_logical: int) -> None:
        """Allocate pages so logical positions [0, upto_logical] are backed."""
        need = upto_logical // self.page_size
        for j in range(need + 1):
            if self.tables[slot, j] == PageAllocator.TRASH:
                (p,) = self._alloc(1)
                self.tables[slot, j] = p
                self.stream_pages[slot].append(p)

    def _on_slot_released(self, slot: int) -> None:
        cache = self.prefix_cache
        if cache is None:
            self.allocator.release(self.stream_pages[slot])
        else:
            # registered pages (owned-and-published or borrowed) drop one
            # reference and stay cached; unregistered owned pages free
            for pid in {int(p) for p in self.tables[slot]}:
                if pid == PageAllocator.TRASH:
                    continue
                if pid in cache.refs:
                    cache.dec(pid)
                else:
                    self.allocator.release([pid])
        self.stream_pages[slot] = []
        self.tables[slot, :] = PageAllocator.TRASH

    def _begin_prefill(self, stream, slot: int) -> None:
        super()._begin_prefill(stream, slot)
        cache = self.prefix_cache
        if cache is None:
            return
        q = stream.prefill_queue
        ps = self.page_size
        # one hashing pass feeds every lookup below
        aligned = len(q) >= ps and len(q) % ps == 0
        digs = cache.digests(q, ps, len(q) // ps)
        # exact hit: a page-aligned prompt whose every page AND final-
        # position logits are cached needs no forward pass at all. The
        # pages are borrowed read-only (decode writes start at position
        # len(q), i.e. the next page).
        if aligned and all(d in cache.by_key for d in digs):
            row = cache.match_logits(digs[-1])
            if row is not None:
                pids = [cache.by_key[d] for d in digs]
                for pid in pids:
                    cache.acquire(pid)
                for j, pid in enumerate(pids):
                    self.tables[slot, j] = pid
                stream.prefill_pos = len(q)
                stream.n_past = len(q)
                stream.last_logits = row
                stream.prefilling = False
                return
        chain = cache.match_digests(digs[: (len(q) - 1) // ps])
        # full-prefix hit whose logits row was evicted: copy the cached
        # last page into an owned page (copy-on-write) and re-evaluate only
        # the last prompt token, whose write lands in the copy
        cow = None
        if aligned and len(chain) == len(q) // ps - 1:
            src = cache.by_key.get(digs[-1])
            if src is not None:
                cache.acquire(src)  # pin across the alloc (eviction safety)
                try:
                    (dst,) = self._alloc(1)
                except MemoryError:
                    dst = None  # pool too tight; fall back to the chunk tail
                if dst is not None:
                    _copy_page(self.pool, src, dst)
                    cow = dst
                cache.dec(src)
        if not chain and cow is None:
            return
        for j, pid in enumerate(chain):
            self.tables[slot, j] = pid
        if cow is not None:
            self.tables[slot, len(chain)] = cow
            self.stream_pages[slot].append(cow)  # owned, freed on release
            stream.prefill_pos = len(q) - 1
        else:
            # prefill resumes at the matched boundary; >=1 token remains
            stream.prefill_pos = len(chain) * ps
        stream.n_past = stream.prefill_pos

    def _register_prompt_pages(self, stream, slot: int) -> list:
        """Publish this stream's freshly-filled FULL prompt pages. Returns
        the digest chain so completion can reuse it (one hashing pass)."""
        cache = self.prefix_cache
        if cache is None:
            return []
        full = stream.prefill_pos // self.page_size
        digests = cache.digests(stream.prefill_queue, self.page_size, full)
        for j in range(full):
            pid = int(self.tables[slot, j])
            if pid != PageAllocator.TRASH:
                cache.register(digests[j], pid)
        return digests

    def _window_pages(self, extra: int = 1) -> int:
        """Logical pages the attention of a step (or a block of `extra`
        tokens) reads: they cover every slot's n_past + extra, within the
        table's width."""
        max_past = max(
            (s.n_past for s in self.slots if s is not None), default=0
        )
        wp = max(1, -(-(max_past + extra) // self.page_size))
        return min(wp, self.pages_per_stream)

    # -- prefill / decode ---------------------------------------------------

    def _prefill_chunk(self, stream, slot: int) -> None:
        """One prompt chunk through a B=1 paged forward (the pool and this
        stream's table row are all the state it touches). Raises
        MemoryError when the pool has no page for the chunk."""
        toks = stream.prefill_queue
        pos = stream.prefill_pos
        chunk = toks[pos : pos + self.n_batch]
        self._ensure_pages(slot, pos + len(chunk) - 1)
        bucket = _chunk_bucket(len(chunk), self.n_batch)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, : len(chunk)] = chunk
        wp = -(-(pos + len(chunk)) // self.page_size)
        dev = self.device
        logits, _, _ = paged_forward_batched(
            self.spec, self.params, torch.tensor(ids, device=dev),
            torch.tensor([pos], dtype=torch.int32, device=dev),
            torch.tensor(self.tables[slot : slot + 1], device=dev),
            self.pool, wp,
        )
        stream.prefill_pos = pos + len(chunk)
        stream.n_past = stream.prefill_pos
        stream.last_logits = logits[0, len(chunk) - 1].cpu().numpy()
        digests = self._register_prompt_pages(stream, slot)
        if stream.prefill_pos >= len(toks):
            stream.prefilling = False
            cache = self.prefix_cache
            if (cache is not None and digests
                    and len(toks) % self.page_size == 0):
                # page-aligned completion: digests[-1] covers the whole
                # prompt, so an exact repeat skips prefill entirely
                cache.register_logits(digests[-1], stream.last_logits)

    def step(self):
        """One decode step across decode-ready streams (host sampling);
        prefilling streams advance one chunk first."""
        self._admit()
        self._advance_prefills()
        events = self._drain_retired()
        decodable = self._decodable()
        if not decodable:
            return events
        ids = np.zeros((self.max_streams, 1), np.int64)
        n_past = np.zeros(self.max_streams, np.int32)
        # dummy writes of prefilling slots land at their frontier (the next
        # chunk overwrites them) or on the trash page
        for slot, s in enumerate(self.slots):
            if s is not None and s.prefilling:
                n_past[slot] = s.prefill_pos
        sampled = {}
        for slot, stream in decodable:
            tok = self._host_sample(stream)
            try:
                self._ensure_pages(slot, stream.n_past)
            except MemoryError:
                # no page for the next token: retire the stream
                self._retire(stream, "kv_oom", slot=slot)
                continue
            sampled[slot] = tok
            ids[slot, 0] = tok
            n_past[slot] = stream.n_past

        events += self._drain_retired()
        if not sampled:
            return events
        wp = max(1, -(-(int(n_past.max()) + 1) // self.page_size))
        dev = self.device
        # the tables are copied at dispatch, so a retirement inside
        # _finish_token cannot free a page this step still writes
        logits_dev, _, _ = paged_forward_batched(
            self.spec, self.params, torch.tensor(ids, device=dev),
            torch.tensor(n_past, device=dev),
            torch.tensor(self.tables, device=dev), self.pool, wp,
        )
        self.decode_dispatches += 1
        emitted = []
        for slot, tok in sampled.items():
            stream = self.slots[slot]
            emitted.append((slot, stream))
            events.append(
                self._finish_token(slot, stream, tok, stream.last_logits)
            )
        logits = logits_dev[:, 0, :].cpu().numpy()
        for slot, stream in emitted:
            stream.last_logits = logits[slot]
        return events

    # -- multi-step on-device decode ----------------------------------------

    def _plan_multi(self, active, n_steps: int) -> int:
        """Allocate pages so that every active stream can decode n_steps
        tokens without the host; halve n_steps until the pool (with its
        evictable prefix pages) has them. Returns the n_steps that fits, 0
        to fall back to single steps."""
        while n_steps > 1:
            need = 0
            for slot, s in active:
                last = min(s.n_past + n_steps, self.spec.n_ctx) - 1
                have = sum(
                    1 for j in range(last // self.page_size + 1)
                    if self.tables[slot, j] != PageAllocator.TRASH
                )
                need += last // self.page_size + 1 - have
            avail = self.allocator.available + (
                self.prefix_cache.evictable if self.prefix_cache else 0
            )
            if need <= avail:
                break
            n_steps //= 2
        else:
            return 0
        try:
            for slot, s in active:
                self._ensure_pages(
                    slot, min(s.n_past + n_steps, self.spec.n_ctx) - 1
                )
        except MemoryError:  # the estimate raced an eviction
            return 0
        return n_steps

    def _dispatch_multi(self, logits, n_past, n_steps, sampler, u,
                        values=None, write_mask=None, penalty_state=None,
                        logprobs_n=None, return_state=False):
        # the paged forward has no write mask: an empty slot's rows land on
        # the trash page (its table is all trash), but a prefilling slot's
        # table already maps page 0 to a real, possibly shared prefix
        # page, so its dummy rows park at the prefill frontier (the next
        # chunk overwrites them), as in the per-token step
        n_past = np.array(n_past)
        for slot, s in enumerate(self.slots):
            if s is not None and s.prefilling:
                n_past[slot] = s.prefill_pos
        active = self._decodable()
        n_steps = self._plan_multi(active, n_steps)
        if n_steps == 0:
            return None
        wp = self._window_pages(extra=n_steps)
        # the step's buffers take copies of the inputs before it runs, and
        # the end-of-block scatter runs before this returns: a retirement
        # in _postprocess_multi cannot free a page the block still writes
        out = paged_decode_loop(
            self.spec, self.params, logits, n_past, self.tables, self.pool,
            n_steps, wp, sampler, sampler_values=values,
            penalty_state=penalty_state, logprobs_n=logprobs_n,
            return_state=return_state,
            uniforms=None if u is None else u[:n_steps],
        )
        toks, last_logits, _, _, fstate, lp = unpack_decode_out(
            out, return_state, logprobs_n)
        return self._block_result(toks, last_logits, n_steps, lp, fstate)
