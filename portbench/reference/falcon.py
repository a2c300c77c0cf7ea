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
"""

from __future__ import annotations

import torch

from portbench.reference.model import (Base, attend, gelu_tanh, layer_norm,
                                       rope_neox)

LN_EPS = 1e-5


class Reference(Base):
    def _layer(self, i, hs):
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
            a = layer_norm(h, lw, lb, LN_EPS)
            qkv = self.mm(a, wqkv)
            q = qkv[:, :H * D].reshape(T, H, D)
            k = qkv[:, H * D:(H + Hkv) * D].reshape(T, Hkv, D)
            v = qkv[:, (H + Hkv) * D:].reshape(T, Hkv, D)
            o = attend(rope_neox(q), rope_neox(k), v)
            h = h + self.mm(o, wd) + self.mm(gelu_tanh(self.mm(a, w4h)),
                                             w4h_h)
            out.append(h)
        return out

    def _logits(self, seqs, rows, reduce):
        emb = self.w("transformer.word_embeddings.weight")
        hs = [emb[torch.as_tensor(s, dtype=torch.long, device=self.dev)]
              for s in seqs]
        del emb
        for i in range(self.hp["n_layer"]):
            hs = self._layer(i, hs)
        nw, nb, head = (self.w("transformer.ln_f.weight"),
                        self.w("transformer.ln_f.bias"),
                        self.w("lm_head.weight"))
        out = []
        for i, (h, r) in enumerate(zip(hs, rows)):
            x = layer_norm(h[torch.as_tensor(r, dtype=torch.long,
                                             device=self.dev)], nw, nb,
                           LN_EPS)
            out.append(reduce(i, self.mm(x, head)))
        return out
