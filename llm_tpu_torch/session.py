"""InferenceSession: KV cache + prompt feeding + host-sampled generation.

The counterpart of `llm_tpu/session.py` for the `infer` path:

- feed_prompt: chunks of n_batch with the ContextFull guard; each chunk is
  padded up to the n_batch bucket (padding beyond n_past is written to the
  cache, masked, and later overwritten), with the exact shape near the
  context end so the write never runs past it.
- infer_next_token: sample on the host -> push -> evaluate -> EndOfText on
  EoT.
- rewind: pop tokens and decrement n_past; cache entries are indexed by
  absolute position, so the cache needs no invalidation.

Snapshots, perplexity and on-device sampling are not ported yet.
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
