"""Byte-level BPE tokenizer for GGUF gpt2-family vocabularies.

GGUF checkpoints whose metadata says `tokenizer.ggml.model = "gpt2"` store
the vocabulary in GPT-2's byte-to-unicode REMAPPED form ("Ġ" = space) plus
a ranked `tokenizer.ggml.merges` list; their scores are meaningless, so the
classic score-greedy embedded tokenizer (tokenizer/embedded.py) would
mis-tokenize them. This module implements the standard byte-level BPE:
regex pre-split, byte→unicode mapping, then lowest-rank pair merging.

The reference has no BPE path of its own — it either uses the classic
container's scored vocab (llm-base/src/tokenizer/embedded: greedy-DP) or
defers to an external HF tokenizer; GGUF support itself is beyond the
reference (this framework's container extension), so this component is
new-surface, patterned on the public GPT-2 BPE algorithm.
"""

from __future__ import annotations

import re
from typing import Optional

TokenId = int


class BpeError(Exception):
    pass


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map: visible latin-1 bytes
    map to themselves, the rest to 256+offset codepoints."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}

# GPT-2's pre-split pattern for the stdlib `re` engine: \p{L} -> [^\W\d_],
# \p{N} -> \d, punctuation -> non-space-non-word OR underscore (GPT-2
# classes _ as punctuation; bare [^\s\w] would silently drop it)
_SPLIT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"""
    r"""|\s+(?!\S)|\s+"""
)


class BpeTokenizer:
    """Same surface as EmbeddedTokenizer (id/token/tokenize/decode), built
    from a GGUF vocab (tokens utf-8 in mapped form) + ranked merges."""

    def __init__(
        self,
        tokens: list[bytes],
        merges: list[bytes | str],
        token_types: Optional[list[int]] = None,
        bos_id: Optional[int] = None,
    ):
        # mapped-form string of each id (for merging / encode lookup)
        self._mapped: list[str] = [
            t.decode("utf-8", errors="replace") for t in tokens
        ]
        self._encoder = {m: i for i, m in enumerate(self._mapped)}
        # raw bytes of each id (for decode / the bytes-facing interface)
        self._raw: list[bytes] = [
            bytes(_U2B[ch] for ch in m) if all(ch in _U2B for ch in m) else t
            for m, t in zip(self._mapped, tokens)
        ]
        self._raw_index = {r: i for i, r in enumerate(self._raw)}
        self._ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(merges):
            s = m.decode("utf-8") if isinstance(m, bytes) else m
            a, _, b = s.partition(" ")
            self._ranks[(a, b)] = rank
        # GGUF token_type: 1=normal, 2=unknown, 3=control/special, 4=user,
        # 5=unused, 6=byte
        self._special = {
            i for i, t in enumerate(token_types or []) if t in (2, 3)
        }
        self.bos_id = bos_id
        self._cache: dict[str, list[str]] = {}

    # -- EmbeddedTokenizer-compatible surface ------------------------------

    def id(self, token: bytes) -> Optional[int]:
        return self._raw_index.get(token)

    def token(self, idx: int) -> bytes:
        return self._raw[idx]

    def __len__(self) -> int:
        return len(self._raw)

    def _bpe(self, piece: str) -> list[str]:
        got = self._cache.get(piece)
        if got is not None:
            return got
        parts = list(piece)
        while len(parts) > 1:
            best, where = None, -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best is None or r < best):
                    best, where = r, i
            if best is None:
                break
            parts[where : where + 2] = [parts[where] + parts[where + 1]]
        if len(self._cache) < 32768:
            self._cache[piece] = parts
        return parts

    def tokenize(self, text: str, bos: bool) -> list[tuple[bytes, TokenId]]:
        out: list[tuple[bytes, TokenId]] = []
        if bos and self.bos_id is not None:
            out.append((self._raw[self.bos_id], self.bos_id))
        for piece in _SPLIT.findall(text):
            mapped = "".join(_B2U[b] for b in piece.encode("utf-8"))
            for part in self._bpe(mapped):
                tid = self._encoder.get(part)
                if tid is None:
                    # unmergeable: fall back to per-character byte tokens
                    for ch in part:
                        cid = self._encoder.get(ch)
                        if cid is None:
                            raise BpeError(
                                f"vocabulary lacks byte token {ch!r}"
                            )
                        out.append((self._raw[cid], cid))
                else:
                    out.append((self._raw[tid], tid))
        return out

    def decode(self, tokens: list[int], skip_special_tokens: bool) -> bytes:
        return b"".join(
            self._raw[t]
            for t in tokens
            if not (skip_special_tokens and t in self._special)
        )

    def iter_tokens(self):
        return enumerate(self._raw)
