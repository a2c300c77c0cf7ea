"""A tensor's raw GGML bytes as f32 weights, with plain torch ops: f32
here, each block format by its own file's `dequant` (`formats/<fmt>.py`,
written from ggml's C, not from the port)."""

from __future__ import annotations

import torch

from portbench import plugins


def dequant(fmt: str, raw: torch.Tensor, dims) -> torch.Tensor:
    """f32 weights [R, K] of a tensor with ggml dims (K, R) (a uint8 tensor
    on any device); a 1-D f32 tensor comes back as [K]."""
    if fmt == "f32":
        return raw.contiguous().view(torch.float32).clone().reshape(
            tuple(reversed(dims)))
    K, R = dims
    return plugins.fmt(fmt).dequant(raw, K, R)
