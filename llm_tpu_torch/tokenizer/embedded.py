"""The built-in GGML tokenizer: scored-vocab longest-match DP.

Re-implements the SentencePiece-style dynamic program of the reference
(llm/crates/llm-base/src/tokenizer/embedded.rs:78-134):
score(token) = len(token)^2, maximize total score over a segmentation of the
UTF-8 byte string; BOS is hardcoded to token id 1 (embedded.rs:125-128), and
decode skips token id 1 when skipping special tokens (embedded.rs:137-149).
"""

from __future__ import annotations

from typing import Optional


class EmbeddedTokenizerError(Exception):
    pass


class EmbeddedTokenizer:
    def __init__(self):
        self.id_to_token: list[bytes] = []
        self.id_to_token_score: list[float] = []
        self.token_to_id: dict[bytes, int] = {}
        self.max_token_length: int = 0

    def push_token(self, tid: int, content: bytes, score: float) -> None:
        # Loader invariant: ids are sequential (embedded.rs:40-53).
        if len(self.id_to_token) != tid:
            raise ValueError(
                f"the id of token added should be {len(self.id_to_token)}; is {tid}"
            )
        self.max_token_length = max(self.max_token_length, len(content))
        self.id_to_token.append(content)
        self.id_to_token_score.append(score)
        self.token_to_id[content] = tid

    def id(self, token: bytes) -> Optional[int]:
        return self.token_to_id.get(token)

    def token(self, idx: int) -> bytes:
        return self.id_to_token[idx]

    def __len__(self) -> int:
        return len(self.id_to_token)

    def tokenize(self, text: str, bos: bool) -> list[tuple[bytes, int]]:
        data = text.encode("utf-8")
        n = len(data)
        score = [0] * (n + 1)
        prev = [0] * (n + 1)

        for i in range(n):
            max_len = min(n - i, self.max_token_length)
            for sub_len in range(1, max_len + 1):
                tid = self.token_to_id.get(data[i : i + sub_len])
                if tid is not None:
                    local = score[i] + sub_len * sub_len
                    nxt = i + sub_len
                    if score[nxt] < local:
                        score[nxt] = local
                        prev[nxt] = tid

        res: list[tuple[bytes, int]] = []
        i = n
        while i > 0:
            tid = prev[i]
            if tid == 0:
                raise EmbeddedTokenizerError(
                    "the backward pass for the tokenizer encountered a non-set token"
                )
            tok = self.id_to_token[tid]
            res.append((tok, tid))
            i -= len(tok)

        if bos:
            res.append((b"", 1))  # BOS hardcoded to id 1
        res.reverse()
        return res

    def decode(self, tokens: list[int], skip_special_tokens: bool) -> bytes:
        out = bytearray()
        for t in tokens:
            if skip_special_tokens and t == 1:
                continue
            out.extend(self.id_to_token[t])
        return bytes(out)

    def iter_tokens(self):
        return zip(self.id_to_token, self.id_to_token_score)
