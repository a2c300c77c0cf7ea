"""Tokenizer layer: dual tokenizer (embedded GGML vocab / HuggingFace).

Mirrors llm/crates/llm-base/src/tokenizer/mod.rs:
- TokenizerSource: embedded vocab, HF tokenizer.json file/string/remote
- Tokenizer: enum dispatch over EmbeddedTokenizer and HuggingFaceTokenizer
- Prompt: text-or-tokens input
- TokenBias: "TID=BIAS,TID=BIAS" parser
- TokenUtf8Buffer: byte accumulation until valid UTF-8 (util.rs:40-74)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence, Union

from llm_tpu_torch.tokenizer.embedded import EmbeddedTokenizer
from llm_tpu_torch.tokenizer.huggingface import HuggingFaceTokenizer

TokenId = int


class TokenizationError(Exception):
    pass


class InvalidTokenId(TokenizationError):
    def __init__(self, tid: int):
        super().__init__(f"invalid token id: {tid}")
        self.token_id = tid


class TokenizerLoadError(Exception):
    pass


class TokenizerSource:
    """Where to obtain the tokenizer (tokenizer/mod.rs:56-106)."""

    def __init__(self, kind: str, value=None):
        assert kind in ("embedded", "hf_file", "hf_string", "hf_remote")
        self.kind = kind
        self.value = value

    @classmethod
    def embedded(cls) -> "TokenizerSource":
        return cls("embedded")

    @classmethod
    def hf_tokenizer_file(cls, path: str | Path) -> "TokenizerSource":
        return cls("hf_file", Path(path))

    @classmethod
    def hf_tokenizer_string(cls, s: str) -> "TokenizerSource":
        return cls("hf_string", s)

    @classmethod
    def hf_remote(cls, repo_id: str) -> "TokenizerSource":
        return cls("hf_remote", repo_id)

    def retrieve(self) -> Optional["Tokenizer"]:
        """Resolve to a Tokenizer now, or None for `embedded` (which is
        built during model load from the file's own vocab)."""
        if self.kind == "embedded":
            return None
        if self.kind == "hf_file":
            return Tokenizer(HuggingFaceTokenizer.from_file(self.value))
        if self.kind == "hf_string":
            return Tokenizer(HuggingFaceTokenizer.from_string(self.value))
        if self.kind == "hf_remote":
            return Tokenizer(HuggingFaceTokenizer.from_pretrained(self.value))
        raise TokenizerLoadError(f"unknown tokenizer source {self.kind}")


class Tokenizer:
    """Dispatch wrapper over the two tokenizer kinds (tokenizer/mod.rs:109-187)."""

    def __init__(self, inner: Union[EmbeddedTokenizer, HuggingFaceTokenizer]):
        self.inner = inner

    @property
    def is_embedded(self) -> bool:
        return isinstance(self.inner, EmbeddedTokenizer)

    def id(self, token: bytes) -> Optional[TokenId]:
        return self.inner.id(token)

    def token(self, idx: int) -> bytes:
        return self.inner.token(idx)

    def __len__(self) -> int:
        return len(self.inner)

    def tokenize(self, text: str, bos: bool) -> list[tuple[bytes, TokenId]]:
        return self.inner.tokenize(text, bos)

    def decode(self, tokens: Sequence[TokenId], skip_special_tokens: bool) -> bytes:
        return self.inner.decode(list(tokens), skip_special_tokens)


@dataclass
class Prompt:
    """Text-or-tokens prompt (tokenizer/mod.rs:199-266)."""

    text: Optional[str] = None
    tokens: Optional[Sequence[TokenId]] = None

    @classmethod
    def of(cls, value: Union["Prompt", str, Sequence[TokenId]]) -> "Prompt":
        if isinstance(value, Prompt):
            return value
        if isinstance(value, str):
            return cls(text=value)
        return cls(tokens=list(value))

    def to_tokens(self, tokenizer: Tokenizer, beginning_of_sentence: bool) -> list[TokenId]:
        if self.text is not None:
            return [tid for _, tid in tokenizer.tokenize(self.text, beginning_of_sentence)]
        assert self.tokens is not None
        # empty-bytes rule is the reference's (tokenizer/mod.rs:221-228);
        # the range check keeps embedded vocab indexing from raising a raw
        # IndexError (or silently wrapping a NEGATIVE id to the vocab end)
        emb_n = len(tokenizer) if tokenizer.is_embedded else None
        for t in self.tokens:
            if (t < 0 or (emb_n is not None and t >= emb_n)
                    or len(tokenizer.token(t)) == 0):
                raise InvalidTokenId(t)
        return list(self.tokens)

    def is_empty(self) -> bool:
        if self.text is not None:
            return len(self.text) == 0
        return not self.tokens


class TokenBias:
    """Sorted, deduped (token_id, bias) list (tokenizer/mod.rs:277-338)."""

    def __init__(self, pairs: Sequence[tuple[TokenId, float]] = ()):
        seen: dict[int, float] = {}
        for tid, bias in sorted(pairs, key=lambda kv: kv[0]):
            seen.setdefault(tid, bias)
        self._pairs = sorted(seen.items())

    @classmethod
    def empty(cls) -> "TokenBias":
        return cls()

    @classmethod
    def from_str(cls, s: str) -> "TokenBias":
        pairs = []
        for item in s.split(","):
            if "=" not in item:
                raise ValueError("Missing '=' in bias item")
            k, v = item.strip().split("=", 1)
            pairs.append((int(k.strip()), float(v.strip())))
        return cls(pairs)

    def get(self, tid: TokenId) -> Optional[float]:
        for t, b in self._pairs:
            if t == tid:
                return b
        return None

    def __iter__(self):
        return iter(self._pairs)

    def __bool__(self):
        return bool(self._pairs)

    def __eq__(self, other):
        return isinstance(other, TokenBias) and self._pairs == other._pairs


@dataclass
class TokenUtf8Buffer:
    """Buffers token bytes until they form valid UTF-8 (util.rs:40-74).

    `push` returns a decoded string when the accumulated bytes are valid
    UTF-8 (possibly spanning multiple tokens), else None.
    """

    buffer: bytearray = field(default_factory=bytearray)

    def push(self, token: bytes) -> Optional[str]:
        self.buffer.extend(token)
        try:
            s = self.buffer.decode("utf-8")
        except UnicodeDecodeError:
            # If the buffer can never become valid UTF-8 again (e.g. an
            # invalid leading byte), the reference keeps accumulating and
            # only flushes when valid; mirror that.
            return None
        self.buffer.clear()
        return s
