"""Functional building blocks of the decoder graph, as plain torch ops.

The counterpart of `llm_tpu/ops/layers.py`; numerics mirror the ggml CPU
ops the reference builds its graphs from:

- layer_norm:  ggml_norm, eps = 1e-5
- rms_norm:    ggml_rms_norm, eps = LLAMA_DEFAULT_RMS_EPS = 5e-6
- gelu:        ggml_gelu, tanh approximation
- silu:        ggml_silu
- rope:        modes 0 (GPT interleaved pairs) and 2 (NeoX half-rotation),
               theta_j = scale * pos * base^(-2j/n_dims)
- alibi_slopes: ggml_alibi's per-head slopes
"""

from __future__ import annotations

import math
from typing import Optional

import torch

LN_EPS = 1e-5  # ggml_norm eps
RMS_EPS = 5e-6  # LLAMA_DEFAULT_RMS_EPS


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = RMS_EPS) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.reciprocal(torch.sqrt(ms + eps)) * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    eps: float = LN_EPS,
) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = xc * torch.reciprocal(torch.sqrt(var + eps)) * w
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """ggml_gelu: tanh approximation."""
    xf = x.to(torch.float32)
    return (
        0.5 * xf * (1.0 + torch.tanh(0.7978845608028654
                                     * (xf + 0.044715 * xf**3)))
    ).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return (xf * (1.0 / (1.0 + torch.exp(-xf)))).to(x.dtype)


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    n_rot: int,
    mode: int,
    freq_base: float = 10000.0,
    freq_scale: float = 1.0,
) -> torch.Tensor:
    """Rotary position embedding over the first `n_rot` dims of each head.

    x: [..., H, D]; positions: [...] absolute token positions (x's leading
    shape minus the head/dim axes).
    mode 0 = GPT/LLaMA interleaved pairs (2j, 2j+1);
    mode 2 = NeoX pairs (j, j + n_rot/2).
    """
    *lead, H, D = x.shape
    half = n_rot // 2
    xf = x.to(torch.float32)

    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) \
        * 2.0 / n_rot
    inv_freq = torch.pow(freq_base, exps)  # f32: the base is cast to f32
    theta = (freq_scale * positions.to(torch.float32))[..., None] * inv_freq
    cos = torch.cos(theta)[..., None, :]  # [..., 1, half]
    sin = torch.sin(theta)[..., None, :]

    if mode == 0:
        xr = xf[..., :n_rot].reshape(*lead, H, half, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        r0 = x0 * cos - x1 * sin
        r1 = x0 * sin + x1 * cos
        rot = torch.stack([r0, r1], dim=-1).reshape(*lead, H, n_rot)
    elif mode == 2:
        x0 = xf[..., :half]
        x1 = xf[..., half:n_rot]
        r0 = x0 * cos - x1 * sin
        r1 = x0 * sin + x1 * cos
        rot = torch.cat([r0, r1], dim=-1)
    else:
        raise ValueError(f"unsupported rope mode {mode}")

    if n_rot == D:
        return rot.to(x.dtype)
    return torch.cat([rot, xf[..., n_rot:]], dim=-1).to(x.dtype)


def alibi_slopes(n_head: int, bias_max: float, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes, ggml_alibi convention.

    n_heads_log2_floor = 2^floor(log2(n_head));
    heads below it: m0^(h+1) with m0 = 2^(-bias_max / floor);
    heads above:    m1^(2(h-floor)+1) with m1 = 2^(-bias_max/2 / floor).
    """
    floor2 = 1 << int(math.floor(math.log2(n_head)))
    m0 = 2.0 ** (-bias_max / floor2)
    m1 = 2.0 ** (-(bias_max / 2.0) / floor2)
    slopes = []
    for h in range(n_head):
        if h < floor2:
            slopes.append(m0 ** (h + 1))
        else:
            slopes.append(m1 ** (2 * (h - floor2) + 1))
    return torch.tensor(slopes, dtype=torch.float32, device=device)
