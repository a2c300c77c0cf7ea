"""The plain reference of Falcon-7B: its forward pass in f32 with plain
torch ops (TF32 off), no cache and no batching, over the same raw GGML
bytes the program loads.

Equations (as published in tiiuae `modelling_RW`, `parallel_attn`,
`multi_query`, with ggml's numerics where the two differ): a = LN(h) with
bias, eps 1e-5; h += Wdense . attn(a) + W4h_to_h . gelu(Wh_to_4h . a);
q|k|v rows: the 71 query heads, then the one key head and the one value
head; scores q.k / sqrt(d_head); rotary (NeoX halves) over the whole
head, base 10000; a separate lm_head.
Departure: GELU is ggml's tanh approximation, which the ported system
computes, where the published models use the exact erf form.

`precision="fp8"` is the control: each matmul's activation rounded to
float8 e4m3 with a scale a row, and each weight to bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.ggml import dequant

LN_EPS = 1e-5


def _layer_norm(x, w, b):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc / torch.sqrt(var + LN_EPS) * w + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (x + 0.044715 * x ** 3)))


def _rope_neox(x, base: float = 10000.0):
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


def _attend(q, k, v):
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


class Reference:
    """The forward pass of one checkpoint (`hp`: the port-independent
    hyperparameters; `tensors`: name -> (format, dims, host uint8 array)),
    layer by layer on `device`, so that one layer's f32 weights are
    resident at a time."""

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

    def _falcon_layer(self, i, hs):
        p = f"transformer.h.{i}"
        hp = self.hp
        E, H, Hkv = hp["n_embd"], hp["n_head"], hp["n_head_kv"]
        D = E // H
        lw, lb = (self.w(f"{p}.input_layernorm.weight"),
                  self.w(f"{p}.input_layernorm.bias"))
        wqkv = self.w(f"{p}.self_attention.query_key_value.weight")
        wd = self.w(f"{p}.self_attention.dense.weight")
        w4h, w4h_h = (self.w(f"{p}.mlp.dense_h_to_4h.weight"),
                      self.w(f"{p}.mlp.dense_4h_to_h.weight"))
        out = []
        for h in hs:
            T = h.shape[0]
            a = _layer_norm(h, lw, lb)
            qkv = self.mm(a, wqkv)
            q = qkv[:, :H * D].reshape(T, H, D)
            k = qkv[:, H * D:(H + Hkv) * D].reshape(T, Hkv, D)
            v = qkv[:, (H + Hkv) * D:].reshape(T, Hkv, D)
            o = _attend(_rope_neox(q), _rope_neox(k), v)
            h = h + self.mm(o, wd) + self.mm(_gelu(self.mm(a, w4h)), w4h_h)
            out.append(h)
        return out

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
        if self.hp["arch"] != "falcon":
            raise ValueError(f"no reference of {self.hp['arch']!r}")
        emb = self.w("transformer.word_embeddings.weight")
        hs = [emb[torch.as_tensor(s, dtype=torch.long, device=self.dev)]
              for s in seqs]
        del emb
        for i in range(self.hp["n_layer"]):
            hs = self._falcon_layer(i, hs)
        nw, nb, head = (self.w("transformer.ln_f.weight"),
                        self.w("transformer.ln_f.bias"),
                        self.w("lm_head.weight"))
        out = []
        for i, (h, r) in enumerate(zip(hs, rows)):
            x = _layer_norm(h[torch.as_tensor(r, dtype=torch.long,
                                              device=self.dev)], nw, nb)
            out.append(reduce(i, self.mm(x, head)))
        return out
