"""The operations and bytes of a step, counted from a configuration's
published widths and its formats, whatever implements them; and the
least time the card could take for them.

A quantized weight is its GGML block bytes (Q4_0: 4.5 bits a weight),
read once a forward call. A matmul reads its activations as bf16
and writes f32. Attention at position p reads the p + 1 cached rows of
every layer once (K and V, each kv head's D elements in the cache's
element type plus its scale) and the query, and writes the output, both
f32; it takes 4 * H * D operations a row (q.k and p.v). A decode call is
one T=1 forward over its live streams; a prefill call is one chunk of c
prompt tokens at position p, whose logits are needed at its last row only.
Padding rows and dummy slots are not counted. A call's bound is the larger
of its operations over the peak rate and its bytes over the peak
bandwidth.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

# bits a weight of each block format (block bytes * 8 / block elements)
BITS = {"q4_0": 18 * 8 / 32}


def peaks(device_name: str):
    """(operations a second, bytes a second) of the card, from
    peaks.json, or None for a card it does not list."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    p = table["cards"].get(device_name)
    return None if p is None else (p["bf16_flops"], p["hbm_bytes_per_s"])


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def bound_s(self, pk) -> float:
        return max(self.flops / pk[0], self.bytes / pk[1])


@dataclass
class Shape:
    """A model's widths, as the cost counts them."""

    n_layer: int
    n_embd: int
    n_head: int
    n_head_kv: int
    n_vocab: int
    layer_mats: list  # (K, R) of each layer's projections
    bits: float  # a weight's bits in its format
    kv_elem_bytes: float
    kv_scale_bytes: float  # a kv head's scale, a row

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def kv_row_bytes(self) -> float:
        """K and V of one position of one layer."""
        return 2 * self.n_head_kv * (self.head_dim * self.kv_elem_bytes
                                     + self.kv_scale_bytes)

    def matmul(self, rows: int, head_rows: int) -> Cost:
        """`rows` tokens through every layer's projections and `head_rows`
        of them through the output head: weights read once."""
        c = Cost()
        for K, R in self.layer_mats:
            c += Cost(2.0 * rows * K * R,
                      K * R * self.bits / 8 + rows * (2 * K + 4 * R))
        c = Cost(c.flops * self.n_layer, c.bytes * self.n_layer)
        E, V = self.n_embd, self.n_vocab
        return c + Cost(2.0 * head_rows * E * V,
                        E * V * self.bits / 8 + head_rows * (2 * E + 4 * V))

    def attention(self, queries: list, rows_read: int) -> Cost:
        """Queries at the given positions (each attends to position + 1
        rows), reading `rows_read` cached rows once, over every layer."""
        hd = self.n_head * self.head_dim
        flops = 4.0 * hd * sum(p + 1 for p in queries)
        nbytes = rows_read * self.kv_row_bytes() + len(queries) * hd * 8
        return Cost(flops * self.n_layer, nbytes * self.n_layer)


def shape_of(cfg: dict, hp: dict) -> Shape:
    E, F = hp["n_embd"], hp["n_ff"]
    hd = E // hp["n_head"]
    qkv = hd * (hp["n_head"] + 2 * hp["n_head_kv"])
    mats = [(E, qkv), (E, E), (E, F), (F, E)]
    kv = cfg["kv_bytes"]
    return Shape(hp["n_layer"], E, hp["n_head"], hp["n_head_kv"],
                 hp["n_vocab"], mats, BITS[cfg["format"]],
                 kv["element"], kv["scale"])


@dataclass
class Work:
    """The calls of a slice: decode calls as lists of their steps (each the
    positions of its live streams), prefill calls as (position, tokens)."""

    decode: list = field(default_factory=list)
    prefill: list = field(default_factory=list)

    def add_block(self, starts_and_kept: list) -> None:
        """One decode block: (start position, tokens kept) a stream."""
        n = max((k for _, k in starts_and_kept), default=0)
        for j in range(n):
            step = [s + j for s, k in starts_and_kept if k > j]
            self.decode.append(step)

    def costs(self, shape: Shape):
        """[(matmul Cost, attention Cost)] of every call."""
        out = []
        for step in self.decode:
            out.append((shape.matmul(len(step), len(step)),
                        shape.attention(step, sum(p + 1 for p in step))))
        for pos, c in self.prefill:
            out.append((shape.matmul(c, 1),
                        shape.attention(list(range(pos, pos + c)), pos + c)))
        return out

    def bounds(self, shape: Shape, pk) -> dict:
        """Seconds the card needs at least: the matmuls, the decode
        attention, and every call whole."""
        mm = att = whole = 0.0
        for i, (m, a) in enumerate(self.costs(shape)):
            mm += m.bound_s(pk)
            if i < len(self.decode):
                att += a.bound_s(pk)
            whole += (m + a).bound_s(pk)
        return {"matmul": mm, "decode_attention": att, "step": whole}
