"""Continuous-batching inference engine: many streams, one batched decode.

The counterpart of `llm_tpu/serve.py` for host-sampled serving:

- `max_streams` slots of one dense head-major cache [L, B, H_kv, S, D]; a
  request takes a free slot, its prompt advances one `n_batch` chunk per
  engine step (a B=1 forward over the slot, interleaved with the decode of
  running streams), then it joins the batched decode step.
- one decode step runs every slot at T=1: a [max_streams, E] activation
  through each projection kernel and the dense-attention kernel at
  B = max_streams; slots that are empty or prefilling run a dummy token
  whose cache write is masked.
- `step` samples on the host, per stream (its own sampler chain and rng).
- `step_multi` decodes a block of n_steps tokens for every decoding stream
  in one call with on-device sampling (`forward.decode_loop_batched`; on
  the card one CUDA graph replay a token), when every decoding stream
  carries a `device_sampler`. It falls back to `step` only where the
  reference does, and counts each fallback (`multi_fallbacks`).

`PagedEngine` (paged.py) keeps this host contract over a shared page pool.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from llm_tpu_torch.models.forward import (
    KVCache,
    _draws,
    decode_loop_batched,
    forward_batched,
    init_cache_batched,
    unpack_decode_out,
    window_bucket,
)
from llm_tpu_torch.ops.sampling import (
    batched_sampler,
    collect_mu,
    penalty_state,
    store_mu,
)
from llm_tpu_torch.samplers import (
    Mirostat1,
    Mirostat2,
    SamplerChain,
    default_samplers,
    sample_token,
)
from llm_tpu_torch.session import ContextFull
from llm_tpu_torch.tokenizer import Prompt, TokenUtf8Buffer


@dataclass
class GenerationRequest:
    prompt: Union[str, Sequence[int], Prompt]
    max_tokens: Optional[int] = None
    sampler: Optional[object] = None  # defaults to the default chain
    seed: Optional[int] = None
    # callback(stream_id, text) per decoded UTF-8 fragment
    on_token: Optional[Callable[[int, str], None]] = None
    # ops.sampling.DeviceSampler: the stream may decode in on-device blocks
    # (Engine.step_multi) when every decoding stream carries one
    device_sampler: Optional[object] = None
    # record per-generated-token logprobs (+ top-N alternatives when > 0)
    logprobs: Optional[int] = None


@dataclass
class _Stream:
    request_id: int
    request: GenerationRequest
    sampler: object
    rng: np.random.Generator
    tokens: list = field(default_factory=list)
    generated: int = 0
    n_past: int = 0
    last_logits: Optional[np.ndarray] = None
    utf8: TokenUtf8Buffer = field(default_factory=TokenUtf8Buffer)
    decoded_len: int = 0
    text: list = field(default_factory=list)
    logprob_data: list = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""
    # chunked-prefill state: admission assigns a slot immediately and the
    # prompt advances ONE n_batch chunk per engine step, interleaved with
    # decode of running streams (a long prompt never stalls the batch)
    prefilling: bool = False
    prefill_pos: int = 0
    prefill_queue: Optional[list] = None
    kv_wait: bool = False  # paged: last prefill chunk hit an empty pool
    # mirostat: the stream's mu, carried across decode blocks (the one part
    # of the sampler state its token history does not give)
    mirostat_mu: Optional[float] = None


def _chunk_bucket(n: int, n_batch: int) -> int:
    """Pad a prompt tail chunk to the next power-of-two bucket (<= n_batch)
    instead of always the full n_batch: a prefix-cache hit that leaves a
    short tail then prefills ~tail tokens, not a full padded chunk."""
    b = 8
    while b < min(n, n_batch):
        b *= 2
    return min(b, n_batch)


@torch.no_grad()
def _prefill_slot(spec, params, ids, n_past: int, slot: int, cache: KVCache,
                  window=None):
    """Run a prompt chunk for one slot of the batched head-major
    [L, B, H_kv, S, D] cache: a B=1 batched forward over a view of the
    slot, which the forward's cache write updates in place (the slot's
    layers are contiguous, so a T=1 chunk reads them through the
    dense-attention kernel). Returns the chunk's logits [T, V]."""
    quantized = cache.k_scale is not None
    sl = slice(slot, slot + 1)
    slot_cache = KVCache(
        cache.k[:, sl], cache.v[:, sl],
        cache.k_scale[:, sl] if quantized else None,
        cache.v_scale[:, sl] if quantized else None,
    )
    logits, _, _ = forward_batched(spec, params, ids[None], [n_past],
                                   slot_cache, window)
    return logits[0]


@torch.no_grad()
def _decode_all(spec, params, ids, n_past, window, cache, write_mask):
    """One batched decode step: ids [B], n_past [B], cache [L, B, ...];
    dummy slots (write_mask False) never touch the cache."""
    logits, _, _ = forward_batched(spec, params, ids[:, None], n_past, cache,
                                   window, write_mask)
    return logits[:, 0, :]


class Engine:
    """Multi-stream decode engine over a shared immutable model. Single-
    threaded: one thread submits, cancels and steps."""

    # step_multi gathers the sampled tokens' logprobs (and top-N) on the
    # device, so logprob requests ride the block path
    supports_device_logprobs = True

    def __init__(
        self,
        model,
        max_streams: int = 8,
        kv_dtype=torch.bfloat16,
        n_batch: int = 64,  # prefill chunk
    ):
        self.model = model
        self.spec = model.spec
        self.device = model.device
        self.max_streams = max_streams
        self.n_batch = n_batch
        self.params = model.params
        self._init_device_state(kv_dtype)

        self.slots: list[Optional[_Stream]] = [None] * max_streams
        self.pending: list[_Stream] = []
        self.finished: dict[int, _Stream] = {}
        self._retired_events: list = []
        self._next_id = 0
        self._eot = model.eot_token_id()
        # step_multi's record: blocks run, their steps (one graph replay
        # each on the card), and its fallbacks to step() by reason
        self.multi_blocks = 0
        self.multi_block_steps = 0
        self.multi_fallbacks = {"mixed_mirostat": 0, "tight_pool": 0,
                                "context_full": 0}
        self._loop_gen: Optional[torch.Generator] = None

    def _init_device_state(self, kv_dtype) -> None:
        """Allocate the KV store (dense slots here; PagedEngine overrides)."""
        self.cache = init_cache_batched(self.spec, self.max_streams, kv_dtype,
                                        self.device)

    # -- submission ---------------------------------------------------------

    def submit(self, request: GenerationRequest) -> int:
        rid = self._next_id
        self._next_id += 1
        stream = _Stream(
            request_id=rid,
            request=request,
            sampler=request.sampler or default_samplers(),
            rng=np.random.default_rng(request.seed),
        )
        self.pending.append(stream)
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abort a stream (client disconnect / server-side stop sequence):
        pending requests drop; slotted streams retire with reason
        "cancelled" and free their slot (and pages, for paged engines)."""
        for i, s in enumerate(self.pending):
            if s.request_id == request_id:
                self.pending.pop(i)
                self._retire(s, "cancelled")
                return True
        for slot, s in enumerate(self.slots):
            if s is not None and s.request_id == request_id:
                self._retire(s, "cancelled", slot=slot)
                return True
        return False

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _piece(self, stream: _Stream, tok: int) -> bytes:
        """Token bytes for callbacks; HF tokenizers re-decode and diff."""
        tokenizer = self.model.tokenizer
        if tokenizer.is_embedded:
            return tokenizer.token(tok)
        decoded = tokenizer.decode(stream.tokens, True)
        text = decoded.decode("utf-8", errors="replace")
        if text.endswith("\N{REPLACEMENT CHARACTER}"):
            return b""
        out = decoded[stream.decoded_len :]
        stream.decoded_len = len(decoded)
        return out

    def has_work(self) -> bool:
        return bool(self.pending) or self.active > 0

    def _retire(self, stream: _Stream, reason: str, slot=None) -> None:
        """Finish a stream and queue its done-event for the next step()."""
        stream.done = True
        stream.finish_reason = reason
        self.finished[stream.request_id] = stream
        if slot is not None:
            self.slots[slot] = None
            self._on_slot_released(slot)
        self._retired_events.append((stream.request_id, "", True))

    def _on_slot_released(self, slot: int) -> None:
        pass  # PagedEngine releases the slot's pages here

    def _drain_retired(self) -> list:
        ev, self._retired_events = self._retired_events, []
        return ev

    def _host_sample(self, stream: _Stream) -> int:
        """The stream's next token, from its host sampler chain. A mirostat
        terminal takes the stream's carried mu and gives its update back,
        so a stream that decodes in device blocks keeps one controller
        across a single step that routes a token through the host."""
        t = (stream.sampler.terminal
             if isinstance(stream.sampler, SamplerChain) else stream.sampler)
        miro = t if isinstance(t, (Mirostat1, Mirostat2)) else None
        if miro is not None and stream.mirostat_mu is not None:
            miro.mu = stream.mirostat_mu
        tok = sample_token(stream.sampler, stream.rng, stream.tokens,
                           stream.last_logits)
        if miro is not None and miro.mu is not None:
            stream.mirostat_mu = float(miro.mu)
        return tok

    def _record_logprob(self, stream: _Stream, tok: int) -> None:
        """Model logprob of the sampled token (from the PRE-update logits
        row it was sampled from) + optional top-N alternatives."""
        row = np.asarray(stream.last_logits, np.float32)
        m = float(row.max())
        logz = row - (m + np.log(np.exp(row - m).sum()))

        def tstr(t: int) -> str:
            return self.model.tokenizer.token(t).decode("utf-8",
                                                        errors="replace")

        entry = {"token": tstr(tok), "logprob": float(logz[tok])}
        n = stream.request.logprobs
        if n:
            top = np.argpartition(logz, -n)[-n:]
            top = top[np.argsort(logz[top])[::-1]]
            entry["top_logprobs"] = {
                tstr(int(t)): float(logz[int(t)]) for t in top
            }
        stream.logprob_data.append(entry)

    def _finish_token(self, slot: int, stream: _Stream, tok: int, logits_row):
        """Shared per-token postprocess: bookkeeping, EoT / max_tokens /
        context-full retirement. Returns the (request_id, text, done) event."""
        if stream.request.logprobs is not None and \
                stream.last_logits is not None:
            self._record_logprob(stream, tok)
        stream.tokens.append(tok)
        stream.n_past += 1
        stream.generated += 1
        stream.last_logits = logits_row

        text = ""
        done = False
        if tok == self._eot:
            done = True
            stream.finish_reason = "eot"
        else:
            out = stream.utf8.push(self._piece(stream, tok))
            if out:
                text = out
                stream.text.append(out)
                if stream.request.on_token:
                    stream.request.on_token(stream.request_id, out)
        limit = stream.request.max_tokens
        if not done and limit is not None and stream.generated >= limit:
            done = True
            stream.finish_reason = "max_tokens"
        if not done and stream.n_past + 1 >= self.spec.n_ctx:
            done = True
            stream.finish_reason = "context_full"
        if done:
            stream.done = True
            self.finished[stream.request_id] = stream
            self.slots[slot] = None
            self._on_slot_released(slot)
        return (stream.request_id, text, done)

    # -- scheduling ---------------------------------------------------------

    def _admit(self) -> None:
        """Assign pending requests to free slots (tokenize + validate only;
        the prompt itself advances chunk-by-chunk in _advance_prefills so a
        long admission never stalls running streams)."""
        for slot in range(self.max_streams):
            if self.slots[slot] is not None or not self.pending:
                continue
            stream = self.pending.pop(0)
            try:
                self._begin_prefill(stream, slot)
                self.slots[slot] = stream
            except ContextFull:
                self._on_slot_released(slot)
                self._retire(stream, "context_full")
            except Exception as e:  # noqa: BLE001 — e.g. untokenizable
                # prompt: a bad request must retire, not crash the engine
                # (and with it every other stream's server thread)
                self._on_slot_released(slot)
                self._retire(stream, f"error: {e}")

    def _begin_prefill(self, stream: _Stream, slot: int) -> None:
        prompt_tokens = Prompt.of(stream.request.prompt).to_tokens(
            self.model.tokenizer, True
        )
        if not prompt_tokens:
            # an empty token-list prompt gets no BOS: the prefill would run
            # an all-padding chunk and sample from garbage logits
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.spec.n_ctx:
            raise ContextFull()
        stream.tokens = list(prompt_tokens)
        if not self.model.tokenizer.is_embedded:
            # baseline for the incremental decode diff: the decoded prompt
            stream.decoded_len = len(
                self.model.tokenizer.decode(stream.tokens, True)
            )
        stream.prefill_queue = prompt_tokens
        stream.prefill_pos = 0
        stream.prefilling = True
        stream.n_past = 0

    def _advance_prefills(self) -> None:
        """Run ONE prompt chunk for every prefilling stream. A paged chunk
        that cannot get pages waits — unless every other slotted stream is
        also waiting (nobody will ever free pages), which would deadlock:
        then the stream retires with kv_oom."""
        for slot, stream in enumerate(self.slots):
            if stream is None or not stream.prefilling:
                continue
            try:
                self._prefill_chunk(stream, slot)
                stream.kv_wait = False
            except MemoryError:
                stream.kv_wait = True
                others = [
                    s for s2, s in enumerate(self.slots)
                    if s is not None and s2 != slot
                ]
                if not others or all(o.kv_wait for o in others):
                    self._retire(stream, "kv_oom", slot=slot)

    def _prefill_chunk(self, stream: _Stream, slot: int) -> None:
        spec = self.spec
        toks = stream.prefill_queue
        pos = stream.prefill_pos
        chunk = toks[pos : pos + self.n_batch]
        bucket = _chunk_bucket(len(chunk), self.n_batch)
        if pos + bucket > spec.n_ctx:  # context boundary: exact shape
            bucket = len(chunk)
        ids = np.zeros(bucket, np.int64)
        ids[: len(chunk)] = chunk
        logits = _prefill_slot(
            spec, self.params, torch.tensor(ids, device=self.device), pos,
            slot, self.cache, window_bucket(pos, spec.n_ctx),
        )
        stream.prefill_pos = pos + len(chunk)
        stream.n_past = stream.prefill_pos
        # one row is all the next sample needs
        stream.last_logits = logits[len(chunk) - 1].cpu().numpy()
        if stream.prefill_pos >= len(toks):
            stream.prefilling = False

    def _decodable(self) -> list[tuple[int, "_Stream"]]:
        return [
            (slot, s)
            for slot, s in enumerate(self.slots)
            if s is not None and not s.prefilling
        ]

    # -- decode -------------------------------------------------------------

    def step(self) -> list[tuple[int, str, bool]]:
        """Admit pending streams, advance prefills one chunk, run ONE
        batched decode step over the decode-ready streams, sample.

        Returns a list of (request_id, new_text, done).
        """
        self._admit()
        self._advance_prefills()
        events = self._drain_retired()
        decodable = self._decodable()
        if not decodable:
            return events

        spec = self.spec
        ids = np.zeros(self.max_streams, np.int64)
        n_past = np.zeros(self.max_streams, np.int32)
        # dummy rows (empty / mid-prefill slots) run with write_mask False:
        # they never touch the cache, so their n_past can stay 0
        mask = np.zeros(self.max_streams, bool)
        sampled: dict[int, int] = {}
        for slot, stream in decodable:
            tok = self._host_sample(stream)
            sampled[slot] = tok
            ids[slot] = tok
            n_past[slot] = stream.n_past
            mask[slot] = True

        max_past = int(n_past.max())
        logits_dev = _decode_all(
            spec, self.params, torch.tensor(ids, device=self.device),
            n_past.tolist(), window_bucket(max_past, spec.n_ctx), self.cache,
            mask.tolist(),
        )
        # the card runs asynchronously: fire the sampled tokens' events
        # BEFORE reading the result. The tokens were sampled from
        # last_logits and do not depend on this forward (it computes the
        # NEXT step's logits), so streaming clients receive token t while
        # the card is busy with t+1.
        emitted = []
        for slot, tok in sampled.items():
            stream = self.slots[slot]
            emitted.append((slot, stream))
            events.append(
                self._finish_token(slot, stream, tok, stream.last_logits)
            )
        logits = logits_dev.cpu().numpy()
        for slot, stream in emitted:
            stream.last_logits = logits[slot]
        return events

    def step_multi(self, n_steps: int = 16) -> list[tuple[int, str, bool]]:
        """Admit, advance prefills one chunk, then decode n_steps tokens for
        every decoding stream in one call with on-device sampling; every
        decoding stream must carry a device_sampler. Empty and prefilling
        slots run dummy rows that write nothing a stream reads.

        The host then cuts each stream at EoT, max_tokens or the context
        boundary and rewinds its n_past (cache rows past it are masked).
        Falls back to one `step` (host sampling, the same kernels) where
        the reference does, counted in `multi_fallbacks`: a batch mixing
        mirostat 1 and 2, a stream at the context boundary, and (paged) a
        pool too tight for a block. A failure on the card raises."""
        self._admit()
        self._advance_prefills()
        retired = self._drain_retired()
        active = self._decodable()
        if not active:
            return retired
        spec = self.spec
        if any(s.request.device_sampler is None for _, s in active):
            raise ValueError("step_multi requires a device_sampler on every "
                             "decoding stream")
        sampler = active[0][1].request.device_sampler
        values = None  # one shared static config
        if any(s.request.device_sampler != sampler for _, s in active):
            # per-stream sampling: a static structure and value tensors
            per_slot = [None] * self.max_streams
            for slot, s in active:
                per_slot[slot] = s.request.device_sampler
            try:
                sampler, values = batched_sampler(per_slot, self.max_streams,
                                                  self.device)
            except ValueError:
                # mirostat 1 beside mirostat 2: each stream's host chain
                # samples this step
                self.multi_fallbacks["mixed_mirostat"] += 1
                return retired + self.step()

        max_past = max(s.n_past for _, s in active)
        n_steps = min(n_steps, spec.n_ctx - 1 - max_past)
        if n_steps <= 0:  # the per-token path retires a full context
            self.multi_fallbacks["context_full"] += 1
            return retired + self.step()

        logits = np.zeros((self.max_streams, spec.n_vocab), np.float32)
        n_past = np.zeros(self.max_streams, np.int32)
        mask = np.zeros(self.max_streams, bool)
        for slot, s in active:
            logits[slot] = s.last_logits
            n_past[slot] = s.n_past
            mask[slot] = True

        # windowed penalties: the state is built from each stream's token
        # history once a block and updated on the device inside it
        pstate = None
        if any(s.request.device_sampler.has_penalties for _, s in active):
            hist = [[] for _ in range(self.max_streams)]
            for slot, s in active:
                hist[slot] = s.tokens
            pstate = penalty_state(hist, sampler.penalty_last_n,
                                   spec.n_vocab)
        # mirostat: each stream's mu rides the block and its stream
        miro = any(s.request.device_sampler.mirostat for _, s in active)
        if miro:
            pstate = {**(pstate or {}),
                      "mu": collect_mu(active, self.max_streams)}
        # logprob requests: the top-N is gathered on the device a step
        lp_reqs = [s.request.logprobs for _, s in active
                   if s.request.logprobs is not None]
        lpn = max(lp_reqs) if lp_reqs else None

        u = self._block_uniforms(n_steps, _draws(sampler))
        dispatched = self._dispatch_multi(logits, n_past, n_steps, sampler,
                                          u, values, mask, pstate, lpn, miro)
        if dispatched is None:  # no block fits the pool now
            self.multi_fallbacks["tight_pool"] += 1
            return retired + self.step()
        toks, last_logits, n_steps, lp, fstate = dispatched
        if fstate is not None:
            store_mu(active, fstate["mu_steps"],
                     self._block_keeps(active, toks))
        return retired + self._postprocess_multi(active, toks, last_logits,
                                                 n_steps, lp)

    def _block_uniforms(self, n_steps: int, draw: bool):
        """A block's uniforms [n_steps, max_streams, V] in [1e-20, 1) from
        the engine's generator (seed 0, on the engine's device), or None
        when the block's sampler takes no noise. Called once a block,
        where the reference advances its loop key (a block cut short by a
        tight pool uses the leading steps)."""
        if not draw:
            return None
        if self._loop_gen is None:
            self._loop_gen = torch.Generator(device=self.device)
            self._loop_gen.manual_seed(0)
        return torch.rand((n_steps, self.max_streams, self.spec.n_vocab),
                          generator=self._loop_gen,
                          device=self.device).clamp_min_(1e-20)

    def _block_keeps(self, active, toks) -> dict:
        """Each slot's kept token count of a block, by the rule of
        _postprocess_multi (EoT first, then the max_tokens budget): where
        a carried sampler state (mirostat's mu) stops."""
        keeps = {}
        n_steps = toks.shape[0]
        for slot, stream in active:
            hit = np.nonzero(toks[:, slot] == self._eot)[0]
            n_keep = int(hit[0]) + 1 if hit.size else n_steps
            limit = stream.request.max_tokens
            if limit is not None:
                n_keep = min(n_keep, max(limit - stream.generated, 1))
            keeps[slot] = n_keep
        return keeps

    def _postprocess_multi(self, active, toks, last_logits, n_steps,
                           lp=None) -> list:
        """The host's bookkeeping after a block: each stream cut at EoT,
        max_tokens or the context boundary, UTF-8 assembly, retirement,
        and logprob records when the block carried them."""
        spec = self.spec

        def tstr(t: int) -> str:
            return self.model.tokenizer.token(t).decode("utf-8",
                                                        errors="replace")

        events = []
        for slot, stream in active:
            col = toks[:, slot]
            hit = np.nonzero(col == self._eot)[0]
            limit = stream.request.max_tokens
            budget = (limit - stream.generated if limit is not None
                      else n_steps)
            n_keep = int(hit[0]) + 1 if hit.size else n_steps
            done = False
            if hit.size and n_keep <= budget:
                done = True
                stream.finish_reason = "eot"
            if n_keep > budget:
                n_keep = budget
                done = True
                stream.finish_reason = "max_tokens"

            text_parts = []
            for i, t in enumerate(col[:n_keep]):
                t = int(t)
                if lp is not None and stream.request.logprobs is not None:
                    lpv, topv, topi = lp
                    entry = {"token": tstr(t),
                             "logprob": float(lpv[i, slot])}
                    n = stream.request.logprobs
                    if n:
                        entry["top_logprobs"] = {
                            tstr(int(topi[i, slot, j])):
                                float(topv[i, slot, j])
                            for j in range(n)
                        }
                    stream.logprob_data.append(entry)
                stream.tokens.append(t)
                stream.generated += 1
                if t != self._eot:
                    out = stream.utf8.push(self._piece(stream, t))
                    if out:
                        text_parts.append(out)
                        stream.text.append(out)
                        if stream.request.on_token:
                            stream.request.on_token(stream.request_id, out)
            stream.n_past += n_keep  # rows past n_keep stay masked
            stream.last_logits = last_logits[slot]
            if not done and stream.n_past + 1 >= spec.n_ctx:
                done = True
                stream.finish_reason = "context_full"
            if done:
                stream.done = True
                self.finished[stream.request_id] = stream
                self.slots[slot] = None
                self._on_slot_released(slot)
            events.append((stream.request_id, "".join(text_parts), done))
        return events

    def _dispatch_multi(self, logits, n_past, n_steps, sampler, u,
                        values=None, write_mask=None, penalty_state=None,
                        logprobs_n=None, return_state=False):
        """Run the n_steps decode block; returns (tokens [n_steps, B],
        last logits [B, V], n_steps, logprob arrays or None, final sampler
        state or None) on the host, or None to fall back to single steps
        (PagedEngine, a tight pool)."""
        spec = self.spec
        max_past = int(n_past.max())
        out = decode_loop_batched(
            spec, self.params, logits, n_past, self.cache, n_steps,
            window_bucket(max_past + n_steps, spec.n_ctx), sampler,
            sampler_values=values,
            write_mask=(None if write_mask is None
                        else torch.from_numpy(write_mask).to(self.device)),
            penalty_state=penalty_state, logprobs_n=logprobs_n,
            return_state=return_state, uniforms=u,
        )
        toks, last_logits, _, _, fstate, lp = unpack_decode_out(
            out, return_state, logprobs_n)
        return self._block_result(toks, last_logits, n_steps, lp, fstate)

    def _block_result(self, toks, last_logits, n_steps, lp, fstate):
        """A block's outputs on the host, and its count."""
        self.multi_blocks += 1
        self.multi_block_steps += n_steps
        if lp is not None:
            lp = tuple(a.cpu().numpy() for a in lp)
        if fstate is not None:
            fstate = {k: v.cpu().numpy() for k, v in fstate.items()}
        return (toks.cpu().numpy(), last_logits.cpu().numpy(), n_steps, lp,
                fstate)

    # -- convenience --------------------------------------------------------

    def generate_all(self, requests: Sequence[GenerationRequest],
                     n_steps: int = 1) -> dict[int, str]:
        """Submit everything, run to completion, return id -> text.
        n_steps > 1 decodes in on-device blocks (`step_multi`; every
        request needs a device_sampler)."""
        ids = [self.submit(r) for r in requests]
        while self.has_work():
            if n_steps > 1:
                self.step_multi(n_steps)
            else:
                self.step()
        return {rid: "".join(self.finished[rid].text) for rid in ids}


def throughput_stats(engine: Engine, requests):
    """Run `requests` to completion, returning (texts, tokens/s aggregate over
    exactly these requests)."""
    t0 = time.monotonic()
    before = set(engine.finished)
    texts = engine.generate_all(requests)
    dt = time.monotonic() - t0
    total = sum(
        s.generated for rid, s in engine.finished.items() if rid not in before
    )
    return texts, total / dt if dt > 0 else 0.0
