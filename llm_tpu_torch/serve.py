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
- sampling stays on the host, per stream (its own sampler chain and rng).

`PagedEngine` (paged.py) keeps this host contract over a shared page pool.
The multi-token on-device decode (`step_multi`) is not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from llm_tpu_torch.models.forward import (
    KVCache,
    forward_batched,
    init_cache_batched,
    window_bucket,
)
from llm_tpu_torch.samplers import default_samplers, sample_token
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

    def _sample(self, stream: _Stream) -> int:
        """The stream's next token, from its host sampler chain."""
        return sample_token(stream.sampler, stream.rng, stream.tokens,
                            stream.last_logits)

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
            tok = self._sample(stream)
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

    # -- convenience --------------------------------------------------------

    def generate_all(self,
                     requests: Sequence[GenerationRequest]) -> dict[int, str]:
        """Submit everything, run to completion, return id -> text."""
        ids = [self.submit(r) for r in requests]
        while self.has_work():
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
