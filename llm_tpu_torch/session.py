"""InferenceSession: KV cache + prompt feeding + generation + perplexity +
snapshots.

The counterpart of `llm_tpu/session.py`:

- feed_prompt: chunks of n_batch with the ContextFull guard; each chunk is
  padded up to the n_batch bucket (padding beyond n_past is written to the
  cache, masked, and later overwritten), with the exact shape near the
  context end so the write never runs past it.
- infer_next_token: sample on the host -> push -> evaluate -> EndOfText on
  EoT.
- infer_device: on-device sampling, n_steps tokens a block through
  `forward.decode_loop` (on the card, one CUDA graph replay a token); the
  host reads the tokens once a block.
- rewind: pop tokens and decrement n_past; cache entries are indexed by
  absolute position, so the cache needs no invalidation.
- perplexity: chunks of the context size, BOS at each chunk's first
  position, positions >= min(512, n_ctx / 2) scored; each chunk restarts
  the context at 0 and runs `forward.nll_step` over sub-chunks of 512 (on
  the card: the qmatmul kernel at M = 512), reading the summed NLL back
  once a chunk.
- snapshots: get/restore with a KV size and layout check. The bytes are
  the reference's: a bf16 cache is stored as its raw 2-byte words under
  the dtype "bfloat16", so a snapshot of either package loads in the
  other.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from llm_tpu_torch.models.forward import (
    KVCache,
    forward_step,
    init_cache,
    window_bucket,
)
from llm_tpu_torch.samplers import SamplerChain, default_samplers, sample_token
from llm_tpu_torch.tokenizer import Prompt, TokenUtf8Buffer

TokenId = int


class InferenceError(Exception):
    pass


class ContextFull(InferenceError):
    def __init__(self):
        super().__init__("the context window is full")


class EndOfText(InferenceError):
    def __init__(self):
        super().__init__("reached end of text")


class RewindError(Exception):
    pass


class UnsupportedArchitecture(RewindError):
    def __init__(self):
        super().__init__(
            "this model architecture does not support rewinding"
        )


class NotEnoughTokens(RewindError):
    def __init__(self):
        super().__init__("cannot rewind more tokens than have been processed")


class SnapshotError(Exception):
    pass


class ModelKVMemoryType(enum.Enum):
    """Float16 maps to bfloat16, as in the reference; Int8 holds
    per-(position, head) amax-scaled int8 codes."""

    Float16 = "f16"
    Float32 = "f32"
    Int8 = "q8"

    @property
    def dtype(self):
        if self is ModelKVMemoryType.Float16:
            return torch.bfloat16
        if self is ModelKVMemoryType.Int8:
            return "int8"
        return torch.float32


@dataclass
class InferenceSessionConfig:
    memory_k_type: ModelKVMemoryType = ModelKVMemoryType.Float16
    memory_v_type: ModelKVMemoryType = ModelKVMemoryType.Float16
    n_batch: int = 8


@dataclass
class InferenceParameters:
    sampler: SamplerChain = field(default_factory=default_samplers)


@dataclass
class InferenceRequest:
    prompt: Union[str, Sequence[TokenId], Prompt]
    parameters: Optional[InferenceParameters] = None
    play_back_previous_tokens: bool = False
    maximum_token_count: Optional[int] = None


@dataclass
class OutputRequest:
    all_logits: Optional[list] = None
    embeddings: Optional[list] = None


@dataclass
class InferenceStats:
    feed_prompt_duration: float = 0.0  # seconds
    prompt_tokens: int = 0
    predict_duration: float = 0.0
    predict_tokens: int = 0

    def __str__(self) -> str:
        per_token = (
            self.predict_duration * 1000.0 / self.predict_tokens
            if self.predict_tokens
            else 0.0
        )
        return (
            f"feed_prompt_duration: {int(self.feed_prompt_duration * 1000)}ms\n"
            f"prompt_tokens: {self.prompt_tokens}\n"
            f"predict_duration: {int(self.predict_duration * 1000)}ms\n"
            f"predict_tokens: {self.predict_tokens}\n"
            f"per_token_duration: {per_token:.3f}ms"
        )


class InferenceFeedback(enum.Enum):
    Continue = 0
    Halt = 1


@dataclass
class InferenceResponse:
    """kind in {prompt_token, inferred_token, snapshot_token, eot_token}."""

    kind: str
    text: str = ""


@dataclass
class InferenceSnapshot:
    """n_past + config + tokens + last_logits + raw KV bytes."""

    npast: int
    config: InferenceSessionConfig
    tokens: list
    last_logits: np.ndarray
    memory_k: bytes
    memory_v: bytes
    k_shape: tuple
    v_shape: tuple
    k_dtype: str
    v_dtype: str
    # int8 KV caches carry per-(position, head) scales
    memory_k_scale: Optional[bytes] = None
    memory_v_scale: Optional[bytes] = None
    scale_shape: Optional[tuple] = None


def _tensor_bytes(t: torch.Tensor) -> tuple[bytes, str]:
    """(raw bytes, numpy dtype name); bf16 as its 2-byte words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes(), "bfloat16"
    a = t.numpy()
    return a.tobytes(), str(a.dtype)


def _tensor_from_bytes(b: bytes, dtype: str, shape, device) -> torch.Tensor:
    if dtype == "bfloat16":
        a = np.frombuffer(b, np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(device)
    a = np.frombuffer(b, np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(a.copy()).to(device)


class InferenceSession:
    """Single-stream decode session; one thread at a time, any number of
    sessions may share one Model. The cache lives on the model's device."""

    def __init__(self, model, config: Optional[InferenceSessionConfig] = None):
        self.model = model
        self.config = config or InferenceSessionConfig()
        kv_dtype = self.config.memory_k_type.dtype
        self.cache: KVCache = init_cache(model.spec, kv_dtype, model.device)
        self.n_past: int = 0
        self.tokens: list[TokenId] = []
        self.decoded_tokens: bytearray = bytearray()
        self.last_logits: np.ndarray = np.zeros(model.spec.n_vocab, np.float32)
        # infer_device's mirostat mu, and the sampler it belongs to
        self._mirostat_mu: Optional[float] = None
        self._mirostat_sampler = None

    # -- evaluation ---------------------------------------------------------

    def _evaluate(
        self, batch: Sequence[TokenId], output_request: Optional[OutputRequest]
    ) -> None:
        """Run `batch` through the model at n_past; update logits/cache.

        Pads to the n_batch bucket; the exact shape near the context end
        (padding there would run the cache write past its end)."""
        spec = self.model.spec
        n = len(batch)
        bucket = 1 if n == 1 else self.config.n_batch
        if n > bucket:
            bucket = n
        if self.n_past + bucket > spec.n_ctx:
            bucket = n
        ids = np.zeros(bucket, dtype=np.int64)
        ids[:n] = np.asarray(batch, dtype=np.int64)

        logits, hidden, self.cache = forward_step(
            spec,
            self.model.params,
            torch.from_numpy(ids),
            self.n_past,
            self.cache,
            window_bucket(self.n_past, spec.n_ctx),
        )
        want_all = output_request is not None and (
            output_request.all_logits is not None
        )
        if want_all:
            logits = logits[:n].cpu().numpy()
            self.last_logits = logits[-1]
        else:
            self.last_logits = logits[n - 1].cpu().numpy()
        self.n_past += n
        if output_request is not None:
            if want_all:
                output_request.all_logits.extend(logits.reshape(-1).tolist())
            if output_request.embeddings is not None:
                output_request.embeddings.extend(
                    hidden[:n].cpu().numpy().reshape(-1).tolist()
                )

    # -- the reference API --------------------------------------------------

    def feed_prompt(
        self,
        prompt: Union[str, Sequence[TokenId], Prompt],
        output_request: Optional[OutputRequest] = None,
        callback: Optional[Callable[[bytes], Optional[InferenceFeedback]]] = None,
    ) -> None:
        model = self.model
        beginning_of_sentence = self.n_past == 0
        prompt_tokens = Prompt.of(prompt).to_tokens(
            model.tokenizer, beginning_of_sentence
        )

        if self.n_past + len(prompt_tokens) >= model.context_size:
            raise ContextFull()

        bot = model.bot_token_id()
        halted = False
        for start in range(0, len(prompt_tokens), self.config.n_batch):
            if halted:
                break
            chunk = prompt_tokens[start : start + self.config.n_batch]
            self._evaluate(chunk, output_request)
            for tk in chunk:
                token = self._decode_incremental(tk)
                if callback is not None and tk != bot:
                    fb = callback(bytes(token))
                    if fb is InferenceFeedback.Halt:
                        halted = True
                        break
                self.tokens.append(tk)
                self.decoded_tokens.extend(token)

    def _decode_incremental(self, tk: TokenId) -> bytes:
        """Token bytes for callbacks BEFORE tk is appended to self.tokens;
        HF tokenizers re-decode the whole sequence and diff."""
        return self._diff_decode([*self.tokens, tk], tk)

    def _diff_decode(self, all_ids, tk: TokenId) -> bytes:
        tokenizer = self.model.tokenizer
        if tokenizer.is_embedded:
            return tokenizer.token(tk)
        all_tokens = tokenizer.decode(all_ids, True)
        text = all_tokens.decode("utf-8", errors="replace")
        if text.endswith("\N{REPLACEMENT CHARACTER}"):
            return b""
        return all_tokens[len(self.decoded_tokens) :]

    def rewind(self, num: int) -> list[TokenId]:
        if not self.model.supports_rewind:
            raise UnsupportedArchitecture()
        if num >= self.n_past:
            raise NotEnoughTokens()
        deleted = self.tokens[len(self.tokens) - num :]
        del self.tokens[len(self.tokens) - num :]
        tokenizer = self.model.tokenizer
        if tokenizer.is_embedded:
            removed_len = sum(len(tokenizer.token(t)) for t in deleted)
            del self.decoded_tokens[len(self.decoded_tokens) - removed_len :]
        else:
            # diff-decoded baselines: recompute instead of subtracting
            # standalone token lengths (the reference's documented deviation)
            self.decoded_tokens = bytearray(tokenizer.decode(self.tokens, True))
        self.n_past -= num
        return deleted

    def infer_next_token(
        self,
        rng: np.random.Generator,
        params: Optional[InferenceParameters] = None,
        output_request: Optional[OutputRequest] = None,
    ) -> bytes:
        model = self.model
        if self.n_past + 1 >= model.context_size:
            raise ContextFull()
        sampler = (params or InferenceParameters()).sampler
        next_token = sample_token(sampler, rng, self.tokens, self.last_logits)

        self.tokens.append(next_token)
        self._evaluate([next_token], output_request)

        if next_token == model.eot_token_id():
            raise EndOfText()
        res = self._diff_decode(self.tokens, next_token)
        self.decoded_tokens.extend(res)
        return bytes(res)

    def infer(
        self,
        request: InferenceRequest,
        rng: Optional[np.random.Generator] = None,
        callback: Optional[
            Callable[[InferenceResponse], Optional[InferenceFeedback]]
        ] = None,
        output_request: Optional[OutputRequest] = None,
    ) -> InferenceStats:
        rng = rng or np.random.default_rng()
        callback = callback or (lambda r: InferenceFeedback.Continue)
        maximum_token_count = (
            request.maximum_token_count
            if request.maximum_token_count is not None
            else 2**63
        )

        if request.play_back_previous_tokens:
            buf = TokenUtf8Buffer()
            for tid in self.tokens:
                text = buf.push(self.model.tokenizer.token(tid))
                if text is not None:
                    if callback(
                        InferenceResponse("snapshot_token", text)
                    ) is InferenceFeedback.Halt:
                        break

        stats = InferenceStats()
        start_at = time.monotonic()
        params = request.parameters or InferenceParameters()

        prompt = Prompt.of(request.prompt)
        if not prompt.is_empty():
            def feed_cb(token_bytes: bytes):
                buf_text = token_bytes.decode("utf-8", errors="replace")
                return callback(InferenceResponse("prompt_token", buf_text))

            # a Halt during prompt feeding stops the feed only; generation
            # still proceeds, like the reference
            self.feed_prompt(prompt, output_request, feed_cb)

        stats.feed_prompt_duration = time.monotonic() - start_at
        stats.prompt_tokens = self.n_past

        tokens_processed = 0
        buf = TokenUtf8Buffer()
        while tokens_processed < maximum_token_count:
            try:
                token = self.infer_next_token(rng, params)
            except EndOfText:
                break
            text = buf.push(token)
            if text is not None:
                if callback(
                    InferenceResponse("inferred_token", text)
                ) is InferenceFeedback.Halt:
                    break
            tokens_processed += 1

        stats.predict_duration = time.monotonic() - start_at
        stats.predict_tokens = self.n_past
        return stats

    def infer_device(
        self,
        prompt: Union[str, Sequence[TokenId], Prompt],
        maximum_token_count: int,
        sampler=None,  # ops.sampling.DeviceSampler; None = greedy
        n_steps: int = 32,
        seed: int = 0,
        callback: Optional[Callable[[str], None]] = None,
        halt_on_eot: bool = True,
    ) -> InferenceStats:
        """Generate with on-device sampling, n_steps tokens a block: the
        host reads the tokens once a block instead of sampling every token.

        Covers greedy, temperature, top-k, top-p, min-p, tail-free,
        locally-typical, top-a, the flat bias, the windowed repetition /
        frequency / presence penalties and the mirostat 1/2 terminals (mu
        persists on the session across blocks and calls with the same
        sampler). `seed` seeds a torch.Generator on the model's device.
        `halt_on_eot=False` generates through EoT (the CLI sets it when a
        -inf bias bans EoT)."""
        from llm_tpu_torch.models.forward import decode_loop
        from llm_tpu_torch.ops.sampling import (
            mirostat_mu_init,
            penalty_state,
        )

        model = self.model
        spec = model.spec
        dev = self.cache.k.device
        stats = InferenceStats()
        start_at = time.monotonic()

        p = Prompt.of(prompt)
        if not p.is_empty():
            self.feed_prompt(p)
        stats.feed_prompt_duration = time.monotonic() - start_at
        stats.prompt_tokens = self.n_past

        eot = model.eot_token_id()
        key = torch.Generator(device=dev)
        key.manual_seed(seed)
        buf = TokenUtf8Buffer()
        remaining = maximum_token_count
        while remaining > 0:
            steps = min(n_steps, remaining, spec.n_ctx - 1 - self.n_past)
            if steps <= 0:
                break
            window = window_bucket(self.n_past + steps, spec.n_ctx)
            pstate = None
            if sampler is not None and sampler.has_penalties:
                # the penalty window from the session history, a block at a
                # time; the loop updates it on the device
                st = penalty_state([self.tokens], sampler.penalty_last_n,
                                   spec.n_vocab, device=dev)
                pstate = {k: v[0] for k, v in st.items()}
            miro = sampler is not None and sampler.mirostat != 0
            if miro:
                # a different sampler starts afresh at 2 * tau
                if (self._mirostat_mu is None
                        or self._mirostat_sampler != sampler):
                    self._mirostat_mu = mirostat_mu_init(sampler)
                    self._mirostat_sampler = sampler
                pstate = {**(pstate or {}), "mu": torch.tensor(
                    self._mirostat_mu, dtype=torch.float32)}
            out = decode_loop(spec, model.params, self.last_logits,
                              self.n_past, self.cache, steps, window, sampler,
                              key, pstate, return_state=miro)
            toks = out[0].cpu().numpy()
            hit = (np.nonzero(toks == eot)[0] if halt_on_eot
                   else np.array([], np.int64))
            n_keep = int(hit[0]) + 1 if hit.size else steps
            if miro:
                # mu at the truncation point: the block-final mu folds in
                # the surprises of overshoot tokens the host discards
                self._mirostat_mu = float(out[4]["mu_steps"][n_keep - 1])
            for t in toks[:n_keep]:
                t = int(t)
                self.tokens.append(t)
                piece = self._diff_decode(self.tokens, t)
                self.decoded_tokens.extend(piece)
                if t != eot:
                    text = buf.push(piece)
                    if text and callback:
                        callback(text)
            self.n_past += n_keep
            remaining -= n_keep
            if hit.size and n_keep < steps:
                # EoT mid-block: the loop's final logits are the block's
                # end, not the truncation point's; evaluate the last kept
                # token again (it rewrites the same cache row)
                self.n_past -= 1
                self._evaluate([int(toks[n_keep - 1])], None)
                break
            self.last_logits = out[1].cpu().numpy()
            if hit.size:
                break

        stats.predict_duration = time.monotonic() - start_at
        stats.predict_tokens = self.n_past
        return stats

    def perplexity(
        self,
        prompt: Union[str, Sequence[TokenId], Prompt],
        callback: Callable[[int, float], None],
    ) -> None:
        """Chunked perplexity; `callback(chunk, ppl so far)` once a chunk."""
        from llm_tpu_torch.models.forward import nll_step

        model = self.model
        spec = model.spec
        tokens = np.asarray(
            Prompt.of(prompt).to_tokens(model.tokenizer, True), np.int64
        )
        context_size = model.context_size
        n_chunk = len(tokens) // context_size
        first = min(512, context_size // 2)  # the first scored position
        C = min(512, context_size)  # sub-chunk: one forward each
        bot = model.bot_token_id()
        bos = bot if bot is not None else 1

        count = 0
        nll = 0.0
        for i in range(n_chunk):
            start = i * context_size
            chunk = tokens[start : start + context_size].copy()
            chunk[0] = bos
            # logit row j predicts tokens[start + j + 1]; the last row has
            # no target inside the chunk and is never scored
            targets = np.zeros(context_size, np.int64)
            targets[:-1] = tokens[start + 1 : start + context_size]

            self.n_past = 0  # each chunk restarts the context window
            chunk_nll = []
            for p in range(0, context_size, C):
                c = min(C, context_size - p)
                pos = p + np.arange(c)
                valid = (pos >= first) & (pos <= context_size - 2)
                s, self.cache = nll_step(
                    spec,
                    model.params,
                    torch.from_numpy(chunk[p : p + c]),
                    torch.from_numpy(targets[p : p + c]),
                    torch.from_numpy(valid),
                    self.n_past,
                    self.cache,
                    window_bucket(self.n_past + c, spec.n_ctx),
                )
                chunk_nll.append(s)
                self.n_past += c

            nll += float(torch.stack(chunk_nll).sum())  # one read a chunk
            count += context_size - 1 - first
            callback(i, float(np.exp(nll / count)))

    # -- snapshots ----------------------------------------------------------

    def get_snapshot(self) -> InferenceSnapshot:
        c = self.cache
        k, k_dtype = _tensor_bytes(c.k)
        v, v_dtype = _tensor_bytes(c.v)
        ks = vs = None
        if c.k_scale is not None:
            ks, _ = _tensor_bytes(c.k_scale)
            vs, _ = _tensor_bytes(c.v_scale)
        return InferenceSnapshot(
            npast=self.n_past,
            config=self.config,
            tokens=list(self.tokens),
            last_logits=np.asarray(self.last_logits, np.float32).copy(),
            memory_k=k,
            memory_v=v,
            k_shape=tuple(c.k.shape),
            v_shape=tuple(c.v.shape),
            k_dtype=k_dtype,
            v_dtype=v_dtype,
            memory_k_scale=ks,
            memory_v_scale=vs,
            scale_shape=tuple(c.k_scale.shape) if ks is not None else None,
        )

    @classmethod
    def from_snapshot(cls, snapshot: InferenceSnapshot,
                      model) -> "InferenceSession":
        """A session on `model`'s device continuing from `snapshot`."""
        session = cls(model, snapshot.config)
        k, v = session.cache.k, session.cache.v
        if (len(snapshot.memory_k) != k.numel() * k.element_size()
                or len(snapshot.memory_v) != v.numel() * v.element_size()):
            raise SnapshotError(
                "snapshot KV memory size does not match this model/config"
            )
        if tuple(snapshot.k_shape) != tuple(k.shape):
            # the same byte count in another layout (a position-major
            # [L, S, H, D] snapshot): reshaping would transpose the cache
            raise SnapshotError(
                f"snapshot KV layout {tuple(snapshot.k_shape)} does not match "
                f"this build's cache layout {tuple(k.shape)}"
            )
        dev = k.device
        kk = _tensor_from_bytes(snapshot.memory_k, snapshot.k_dtype,
                                snapshot.k_shape, dev)
        vv = _tensor_from_bytes(snapshot.memory_v, snapshot.v_dtype,
                                snapshot.v_shape, dev)
        ks = vs = None
        if snapshot.memory_k_scale is not None:
            ks = _tensor_from_bytes(snapshot.memory_k_scale, "float32",
                                    snapshot.scale_shape, dev)
            vs = _tensor_from_bytes(snapshot.memory_v_scale, "float32",
                                    snapshot.scale_shape, dev)
        session.cache = KVCache(kk, vv, ks, vs)
        session.n_past = snapshot.npast
        session.tokens = list(snapshot.tokens)
        session.last_logits = np.asarray(snapshot.last_logits, np.float32)
        session.decoded_tokens = bytearray(
            b"".join(model.tokenizer.token(t) for t in session.tokens)
            if model.tokenizer.is_embedded
            else model.tokenizer.decode(session.tokens, True)
        )
        return session


# ---------------------------------------------------------------------------
# callback helpers


def feed_prompt_callback(callback):
    """Adapt an InferenceResponse callback for feed_prompt."""

    def inner(token_bytes: bytes):
        text = token_bytes.decode("utf-8", errors="replace")
        return callback(InferenceResponse("prompt_token", text))

    return inner


def conversation_inference_callback(stop_sequence: str, on_token):
    """Stream tokens until the stop sequence (the message prefix) appears."""
    buf = [""]

    def inner(resp: InferenceResponse):
        if resp.kind != "inferred_token":
            return InferenceFeedback.Continue
        text = buf[0] + resp.text
        if text.startswith(stop_sequence):
            buf[0] = ""
            return InferenceFeedback.Halt
        if stop_sequence.startswith(text):
            buf[0] = text
            return InferenceFeedback.Continue
        buf[0] = ""
        on_token(text)
        return InferenceFeedback.Continue

    return inner
