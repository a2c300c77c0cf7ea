"""HuggingFace `tokenizers` wrapper.

Mirrors llm/crates/llm-base/src/tokenizer/huggingface.rs: encode
without special tokens then post-process with `add_special_tokens=bos`, and
decode via the tokenizer. Incremental decode with the U+FFFD guard lives in
the session layer (inference_session.rs:667-681 analog).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


class HuggingFaceTokenizer:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    @classmethod
    def from_file(cls, path: str | Path) -> "HuggingFaceTokenizer":
        from tokenizers import Tokenizer as HFTokenizer

        return cls(HFTokenizer.from_file(str(path)))

    @classmethod
    def from_string(cls, s: str) -> "HuggingFaceTokenizer":
        from tokenizers import Tokenizer as HFTokenizer

        return cls(HFTokenizer.from_str(s))

    @classmethod
    def from_pretrained(cls, repo_id: str) -> "HuggingFaceTokenizer":
        from tokenizers import Tokenizer as HFTokenizer

        return cls(HFTokenizer.from_pretrained(repo_id))

    def id(self, token: bytes) -> Optional[int]:
        return self.tokenizer.token_to_id(token.decode("utf-8"))

    def token(self, idx: int) -> bytes:
        return self.tokenizer.decode([idx], skip_special_tokens=True).encode("utf-8")

    def __len__(self) -> int:
        return self.tokenizer.get_vocab_size(with_added_tokens=False)

    def tokenize(self, text: str, bos: bool) -> list[tuple[bytes, int]]:
        enc = self.tokenizer.encode(text, add_special_tokens=False)
        if bos:
            # post_process with add_special_tokens=True (huggingface.rs:44-65)
            enc = self.tokenizer.post_process(enc, add_special_tokens=True)
        return [(t.encode("utf-8"), i) for t, i in zip(enc.tokens, enc.ids)]

    def decode(self, tokens: list[int], skip_special_tokens: bool) -> bytes:
        return self.tokenizer.decode(
            tokens, skip_special_tokens=skip_special_tokens
        ).encode("utf-8")
