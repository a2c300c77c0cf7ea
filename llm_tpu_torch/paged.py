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
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from llm_tpu_torch.models.forward import (
    _layer_batched,
    _slopes,
    embed_batched,
    head_batched,
)
from llm_tpu_torch.models.spec import ModelSpec
from llm_tpu_torch.ops.packing import pack_int4_rows
from llm_tpu_torch.ops.paged_attention import (
    paged_attention_pass,
    paged_attention_plain,
)
from llm_tpu_torch.serve import Engine, _chunk_bucket


@dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, n_pages, H_kv, page, D] (uint8 [.., D/2]: int4)
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [L, n_pages, H_kv, page] f32
    v_scale: Optional[torch.Tensor] = None

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


@torch.no_grad()
def paged_forward_batched(spec: ModelSpec, params, ids, n_past, tables,
                          cache: PagedKVCache, window_pages: int):
    """Batched forward over paged caches: ids [B, T], n_past [B], tables
    [B, P] physical page ids. Returns (logits [B, T, V] f32, hidden
    [B, T, E] f32, cache), the pool updated in place.

    Every (n_past + t) write position must fall inside an allocated page of
    `tables` (or past the table, which goes to the trash page); reads only
    touch positions < n_past, so `window_pages` just needs to cover
    max(n_past) + T. T=1 steps read the pool through
    `paged_attention_pass`, longer chunks through its plain page loop."""
    dev = cache.k.device
    ids = torch.as_tensor(ids, device=dev)
    n_past = torch.as_tensor(n_past, device=dev).to(torch.int32)
    tables = torch.as_tensor(tables, device=dev).to(torch.int32)
    B, T = ids.shape
    positions = n_past[:, None] + torch.arange(T, dtype=torch.int32,
                                               device=dev)[None, :]
    slopes = _slopes(spec, dev)
    h = embed_batched(spec, params, ids, positions)
    pool_pass = paged_attention_pass if T == 1 else paged_attention_plain
    k_news, v_news = [], []
    for l in range(spec.n_layer):
        online = functools.partial(
            pool_pass, spec, cache.k, cache.v, cache.k_scale, cache.v_scale,
            tables, n_past, slopes, window_pages, l,
        )
        # int4 pools quantize in-flight rows at qmax=7 so the scores seen
        # this step bit-match the codes the pool will hold
        h, k_new, v_new = _layer_batched(
            spec, h, params.layers.layer(l), positions, n_past, (None, None),
            (None, None), online_pass=online, qmax=cache.qmax,
        )
        k_news.append(k_new)
        v_news.append(v_new)
    scatter_rows(cache, _stack_news(k_news, cache.quantized),
                 _stack_news(v_news, cache.quantized), positions, tables)
    logits, h = head_batched(spec, params, h)
    return logits, h, cache


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
    ):
        self.page_size = page_size
        self._n_pages_requested = n_pages
        self.prefix_cache = PrefixCache() if prefix_cache else None
        self.decode_dispatches = 0  # batched T=1 forwards run by step()
        super().__init__(model, max_streams, kv_dtype, n_batch)

    def _init_device_state(self, kv_dtype) -> None:
        self.pages_per_stream = -(-self.spec.n_ctx // self.page_size)
        n_pages = self._n_pages_requested
        if n_pages is None:
            # default: every stream can reach full context (+1 trash page)
            n_pages = 1 + self.max_streams * self.pages_per_stream
        self.pool = init_paged_cache(self.spec, n_pages, self.page_size,
                                     kv_dtype, self.device)
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
            tok = self._sample(stream)
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
