"""GGML block formats dequantized with plain torch ops, written from ggml's
`dequantize_row_q4_0` (ggml-quants.c), not from the port. Every function takes the raw block bytes of an [R, K] tensor (a
uint8 tensor on any device) and returns the f32 weights [R, K]."""

from __future__ import annotations

import torch


def _f16(b: torch.Tensor, off: int) -> torch.Tensor:
    """The f16 field at byte `off` of each block, as f32 [..., 1]."""
    return b[..., off:off + 2].contiguous().view(torch.float16).to(
        torch.float32)


def q4_0(raw: torch.Tensor, K: int, R: int) -> torch.Tensor:
    """Blocks of 32: f16 d, 16 bytes of nibbles; element j < 16 is the low
    nibble of byte j, element j + 16 its high nibble; w = d * (nibble - 8)."""
    b = raw.reshape(R, K // 32, 18)
    d = _f16(b, 0)
    qs = b[..., 2:18].to(torch.int32)
    q = torch.cat([qs & 0xF, qs >> 4], dim=-1).to(torch.float32) - 8.0
    return (d * q).reshape(R, K)


DEQUANT = {"q4_0": q4_0}


def dequant(fmt: str, raw: torch.Tensor, dims) -> torch.Tensor:
    """f32 weights [R, K] of a tensor with ggml dims (K, R); a 1-D f32
    tensor comes back as [K]."""
    if fmt == "f32":
        return raw.contiguous().view(torch.float32).clone()
    K, R = dims
    return DEQUANT[fmt](raw, K, R)
