"""What every architecture's plain reference (`reference/<arch>.py`)
shares: f32 weights from the raw GGML bytes the program loads, a matmul
in f32 with TF32 off or in the control's lower precision, the logits of
chosen rows one sequence at a time, and plain torch forms of the
operations more than one architecture uses.

`precision="fp8"` is the control: each matmul's activation rounded to
float8 e4m3 with a scale a row, and each weight to bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.ggml import dequant


def layer_norm(x, w, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc / torch.sqrt(var + eps) * w + b


def gelu_tanh(x):
    """ggml's GELU: the tanh approximation."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (x + 0.044715 * x ** 3)))


def rope_neox(x, base: float = 10000.0):
    """x [T, H, D] at positions 0..T-1, rotated over the whole head."""
    T, _, D = x.shape
    half = D // 2
    inv = base ** (-np.arange(half, dtype=np.float64) * 2.0 / D)
    ang = np.arange(T, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.tensor(np.cos(ang), dtype=torch.float32, device=x.device)
    sin = torch.tensor(np.sin(ang), dtype=torch.float32, device=x.device)
    cos, sin = cos[:, None, :], sin[:, None, :]
    x0, x1 = x[..., :half], x[..., half:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)


def attend(q, k, v):
    """Causal attention: q [T, H, D], k and v [T, Hkv, D] -> [T, H * D]."""
    T, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("ihd,jhd->hij", q, k) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(causal[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hij,jhd->ihd", p, v).reshape(T, H * D)


class Base:
    """The forward pass of one checkpoint (`hp`: the port-independent
    hyperparameters; `tensors`: name -> (format, dims, host uint8 array))
    on `device`. An architecture's `Reference` subclasses it and defines
    `_logits(seqs, rows, reduce)`, going layer by layer so that one
    layer's f32 weights are resident at a time."""

    def __init__(self, hp: dict, tensors: dict, device,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.hp, self.tensors = hp, tensors
        self.dev = torch.device(device)
        self.precision = precision

    def w(self, name: str) -> torch.Tensor:
        fmt, dims, arr = self.tensors[name]
        raw = torch.from_numpy(np.ascontiguousarray(arr)).to(self.dev)
        return dequant(fmt, raw, dims)

    def mm(self, x, w):
        """x [T, K] @ w [R, K]^T in f32 (or the control's rounding)."""
        if self.precision == "fp8":
            s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
            x = (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
            w = w.to(torch.bfloat16).to(torch.float32)
        return x @ w.t()

    @torch.no_grad()
    def logits(self, seqs: list, rows: list, reduce=None) -> list:
        """For each token sequence, the logits [len(rows[i]), V] of the
        positions rows[i], on the device; with `reduce`, reduce(i, logits)
        of each instead, so that one sequence's logits are held at a
        time."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(seqs, rows, reduce or (lambda i, lg: lg))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _logits(self, seqs, rows, reduce):
        raise NotImplementedError
