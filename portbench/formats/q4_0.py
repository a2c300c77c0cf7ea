"""GGML's Q4_0 block format: blocks of 32 weights in 18 bytes, an f16
scale d then 16 bytes of nibbles. Element j < 16 is the low nibble of
byte j, element j + 16 its high nibble; w = d * (nibble - 8). Written
from ggml's `block_q4_0` and `dequantize_row_q4_0` (ggml-quants.c), not
from the port."""

from __future__ import annotations

import torch

ELEMENTS = 32  # weights a block
BYTES = 18  # bytes a block
BITS = BYTES * 8 / ELEMENTS  # a weight's bits, as the roofline counts them
GGML_TYPE = "Q4_0"


def draw(gen: torch.Generator, n: int, weights: dict, device) -> torch.Tensor:
    """`n` random valid blocks [n, 18] (uint8, on `device`): random bytes,
    with every d drawn uniform in the configuration's `weights["d"]`, as
    `llm_tpu_torch.testing`'s `_random_scalar_quant` makes them (copied,
    not imported)."""
    raw = torch.randint(0, 256, (n, BYTES), dtype=torch.uint8,
                        generator=gen, device=device)
    lo, hi = weights["d"]
    d = torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
    raw[:, 0:2] = d.to(torch.float16).view(torch.uint8).view(n, 2)
    return raw


def dequant(raw: torch.Tensor, K: int, R: int) -> torch.Tensor:
    """The f32 weights [R, K] of an [R, K] tensor's raw block bytes (a
    uint8 tensor on any device)."""
    b = raw.reshape(R, K // ELEMENTS, BYTES)
    d = b[..., 0:2].contiguous().view(torch.float16).to(torch.float32)
    qs = b[..., 2:18].to(torch.int32)
    q = torch.cat([qs & 0xF, qs >> 4], dim=-1).to(torch.float32) - 8.0
    return (d * q).reshape(R, K)
