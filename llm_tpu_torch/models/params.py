"""Canonical model parameters: one weight layout for every architecture.

The counterpart of `llm_tpu/models/params.py`. Fused QKV tensors would be
split into canonical q/k/v by logical-row selection at load time, and every
model becomes the same structure:

    ModelParams
      wte [E, V]  (quantized or dense, K-major)
      wpe (gpt2), emb_norm (bloom), final_norm, lm_head (None = tied to wte)
      layers: LayerParams stacked along a leading n_layer axis

A layer of the stack is a free view (`QuantTensor.layer`, `tensor[l]`).
All seven architectures build here, with the reference's tensor names and
fused-QKV row selections (`_thirds` for GPT-2, BLOOM and MPT, the per-head
interleave `_neox_interleaved` for GPT-NeoX, `_falcon_rows` for Falcon's
n_head + 2 * n_head_kv heads; LLaMA and GPT-J store q/k/v split). q|k|v
and gate|up are fused into one weight each (`fuse_layer_weights`), as the
reference does by default, so each projection is one kernel launch; the
biases stay per member.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Optional, Union

import numpy as np
import torch

from llm_tpu_torch.ggml.quant import dequantize
from llm_tpu_torch.ggml.reader import GgmlReader, TensorInfo
from llm_tpu_torch.models.spec import ModelSpec
from llm_tpu_torch.ops.packing import (
    QuantTensor,
    QuantTensorC,
    decode_ggml,
    dequant,
    dequant_c,
    fuse_quant,
    pack_decoded,
    pack_ggml,
    unfuse_quant,
)
from llm_tpu_torch.ops.qmatmul import coalesce_auto

Weight = Union[QuantTensor, QuantTensorC, torch.Tensor]


@dataclass
class LayerParams:
    """One decoder layer (or the stack of all), canonical form. All matrices
    K-major [in, out]."""

    ln1_w: torch.Tensor
    ln1_b: Optional[torch.Tensor]
    ln2_w: Optional[torch.Tensor]  # None: parallel_shared_ln archs
    ln2_b: Optional[torch.Tensor]
    wq: Optional[Weight]
    bq: Optional[torch.Tensor]
    wk: Optional[Weight]
    bk: Optional[torch.Tensor]
    wv: Optional[Weight]
    bv: Optional[torch.Tensor]
    wo: Weight
    bo: Optional[torch.Tensor]
    w_gate: Optional[Weight]  # swiglu only (llama w1)
    w_up: Optional[Weight]  # llama w3 / c_fc / dense_h_to_4h / up_proj
    b_up: Optional[torch.Tensor]
    w_down: Weight
    b_down: Optional[torch.Tensor]
    # launch-fused q|k|v and gate|up built by fuse_layer_weights (the split
    # tensors are then None)
    w_qkv: Optional[Weight] = None
    w_gate_up: Optional[Weight] = None

    def layer(self, l: int) -> "LayerParams":
        """Layer `l` of the stack: views of every field."""
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (QuantTensor, QuantTensorC)):
                v = v.layer(l)
            elif v is not None:
                v = v[l]
            kw[f.name] = v
        return LayerParams(**kw)


@dataclass
class ModelParams:
    wte: Weight  # [E, V]
    wpe: Optional[Weight]  # [E, n_ctx_train] (gpt2)
    emb_norm_w: Optional[torch.Tensor]  # bloom post-embedding LN
    emb_norm_b: Optional[torch.Tensor]
    final_norm_w: torch.Tensor
    final_norm_b: Optional[torch.Tensor]
    lm_head: Optional[Weight]  # None => tied to wte
    lm_head_b: Optional[torch.Tensor]  # gptj
    layers: LayerParams  # stacked: every field has a leading n_layer axis


def fuse_layer_weights(layers: LayerParams) -> LayerParams:
    """Replace q/k/v (and gate/up) with launch-fused tensors: one kernel
    computes all three projections. The split tensors are dropped, not
    duplicated."""
    kw = {}
    qkv = fuse_quant([layers.wq, layers.wk, layers.wv])
    if qkv is not None:
        kw.update(w_qkv=qkv, wq=None, wk=None, wv=None)
    if layers.w_gate is not None:
        gate_up = fuse_quant([layers.w_gate, layers.w_up])
        if gate_up is not None:
            kw.update(w_gate_up=gate_up, w_gate=None, w_up=None)
    if not kw:
        return layers
    return dataclasses.replace(layers, **kw)


def unfuse_layer_weights(layers: LayerParams) -> LayerParams:
    """Undo fuse_layer_weights (exact plane slicing)."""
    kw = {}
    if layers.w_qkv is not None:
        wq, wk, wv = unfuse_quant(layers.w_qkv)
        kw.update(wq=wq, wk=wk, wv=wv, w_qkv=None)
    if layers.w_gate_up is not None:
        w_gate, w_up = unfuse_quant(layers.w_gate_up)
        kw.update(w_gate=w_gate, w_up=w_up, w_gate_up=None)
    if not kw:
        return layers
    return dataclasses.replace(layers, **kw)


_W_FIELDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_qkv",
             "w_gate_up")


def _dense_upcast_max_bytes() -> int:
    """Size gate of the dense upcast, in packed bytes, read from the
    reference's variables: LLM_TPU_DENSE_UPCAST "0" (default) off, "1"
    always, anything else "auto": models whose packed weight bytes fit
    under LLM_TPU_DENSE_UPCAST_MAX_MB (default 256)."""
    import os

    v = os.environ.get("LLM_TPU_DENSE_UPCAST", "0")
    if v == "0":
        return 0
    if v == "1":
        return 1 << 62
    return int(os.environ.get("LLM_TPU_DENSE_UPCAST_MAX_MB", "256")) << 20


def _packed_bytes(w) -> int:
    if isinstance(w, QuantTensor):
        return sum(p.numel() * p.element_size() for p in w.planes()
                   if p is not None)
    if isinstance(w, QuantTensorC):
        return w.buf.numel() * w.buf.element_size()
    return w.numel() * w.element_size()


def _upcast_weight(w, dtype):
    """One quantized weight (layer-stacked or not) -> dense [L?, K, R] on
    its device; a dense weight is returned as it is."""
    if isinstance(w, QuantTensorC):
        if w.buf.dim() == 3:  # stacked [L, ...]
            return torch.stack([dequant_c(w.layer(i)).to(dtype)
                                for i in range(w.buf.shape[0])])
        return dequant_c(w).to(dtype)
    if isinstance(w, QuantTensor):
        return dequant(w).to(dtype)  # [..., K, R]: stacked layers too
    return w


def upcast_model_weights(params: ModelParams,
                         dtype=torch.bfloat16) -> ModelParams:
    """Hold a quantized model's weights dense on the device (the file's
    format unchanged: a q8_0 file in, bf16 weights resident). Fused q|k|v
    and gate|up are unfused first: a dense product has no launch to save.
    Every product then runs in `ops/qmatmul.qmatmul`'s dense branch, with
    bf16 operands and f32 accumulation on the card."""
    layers = unfuse_layer_weights(params.layers)
    lk = {f: _upcast_weight(getattr(layers, f), dtype) for f in _W_FIELDS
          if isinstance(getattr(layers, f), (QuantTensor, QuantTensorC))}
    pk = {f: _upcast_weight(getattr(params, f), dtype)
          for f in ("wte", "wpe", "lm_head")
          if isinstance(getattr(params, f), (QuantTensor, QuantTensorC))}
    return dataclasses.replace(params, layers=dataclasses.replace(layers, **lk),
                               **pk)


def maybe_upcast_dense(params: ModelParams) -> ModelParams:
    """Apply the dense-upcast gate (`_dense_upcast_max_bytes`). As in the
    reference, the size sum leaves out `wpe`, and the upcast goes to bf16
    on every device, the CPU included."""
    total = sum(
        _packed_bytes(w)
        for w in [getattr(params.layers, f) for f in _W_FIELDS]
        + [params.wte, params.lm_head]
        if w is not None
    )
    if total <= _dense_upcast_max_bytes():
        return upcast_model_weights(params)
    return params


def coalesce_layer_weights(params: ModelParams,
                           min_k: int = 2048) -> ModelParams:
    """The same model with every quantized layer weight that the
    reference's size gate admits (`coalesce_auto`) in the coalesced
    layout, on the weights' device; the embedding and lm_head stay planes.
    The loader keeps planes: this is for callers that ask for the layout."""
    kw = {}
    for f in _W_FIELDS:
        w = getattr(params.layers, f)
        if isinstance(w, QuantTensor):
            c = coalesce_auto(w, min_k=min_k)
            if c is not None:
                kw[f] = c
    return dataclasses.replace(
        params, layers=dataclasses.replace(params.layers, **kw))


def _stack(xs: list):
    """Stack one field across layers (None stays None)."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], QuantTensor):
        q0 = xs[0]
        if any(q.fmt_name != q0.fmt_name or q.lo.shape != q0.lo.shape
               for q in xs):
            raise ValueError("model layers are not homogeneous (mixed quant "
                             "formats or shapes across layers)")

        def st(name):
            planes = [getattr(q, name) for q in xs]
            return None if planes[0] is None else torch.stack(planes)

        return QuantTensor(q0.fmt_name, q0.k, q0.r, st("lo"), st("hi"),
                           st("scale"), st("bias"), q0.splits)
    return torch.stack(xs)


def stack_layers(layers: list[LayerParams]) -> LayerParams:
    """Stack per-layer params along a new leading axis, fusing q|k|v and
    gate|up first."""
    layers = [fuse_layer_weights(l) for l in layers]
    return LayerParams(**{
        f.name: _stack([getattr(l, f.name) for l in layers])
        for f in fields(LayerParams)
    })


class WeightSource:
    """Fetch-and-pack adapter over a GgmlReader (and optional LoRA
    adapters): packs each tensor on `device` straight from its raw bytes.
    A quantized tensor whose rows are selected (a fused q|k|v) is fetched
    and decoded once for all of its selections: the decode is kept until
    another tensor is asked for. A LoRA patch is applied to the raw bytes
    on the host, before packing (`lora.LoraAdapter.patch`), as the
    reference's `WeightSource._raw` does."""

    def __init__(self, reader: GgmlReader, device, progress=None,
                 lora_adapters=None):
        self.reader = reader
        self.device = torch.device(device)
        self.progress = progress
        self.lora_adapters = lora_adapters or []
        self._loaded = 0
        self._decoded = (None, None)  # (name, decode_ggml's result)

    def has(self, name: str) -> bool:
        return name in self.reader.tensors

    def _raw(self, name: str) -> tuple[TensorInfo, np.ndarray]:
        info = self.reader.tensors[name]
        data = self.reader.fetch(name)
        for lora in self.lora_adapters:
            patched = lora.patch(name, info, data)
            if patched is not None:
                info, data = patched
        self._loaded += 1
        if self.progress is not None:
            self.progress(name, self._loaded, len(self.reader.tensors))
        return info, data

    def matrix(self, name: str, rows: Optional[np.ndarray] = None) -> Weight:
        info = self.reader.tensors[name]
        t = info.element_type
        if self._decoded[0] != name:
            self._decoded = (None, None)  # free the last one first
        if rows is None or not t.is_quantized:
            return pack_ggml(t, self._raw(name)[1], info.dims, rows=rows,
                             device=self.device)
        if self._decoded[0] is None:
            self._decoded = (name, decode_ggml(t, self._raw(name)[1],
                                               *info.dims, self.device))
        return pack_decoded(t, info.dims[0], self._decoded[1], rows=rows)

    def vec(self, name: str,
            rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """1-D tensor (norm weight / bias) as f32."""
        info, data = self._raw(name)
        v = dequantize(info.element_type, data, info.n_elements)
        if rows is not None:
            v = v[rows]
        return torch.from_numpy(np.array(v, np.float32)).to(self.device)

    def maybe_matrix(self, name: str) -> Optional[Weight]:
        return self.matrix(name) if self.has(name) else None


# ---------------------------------------------------------------------------
# fused-QKV row index helpers


def _thirds(n_embd: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    i = np.arange(n_embd)
    return i, n_embd + i, 2 * n_embd + i


def _neox_interleaved(n_head: int, head_dim: int):
    base = np.arange(n_head)[:, None] * 3 * head_dim + np.arange(head_dim)[None, :]
    return base.ravel(), (base + head_dim).ravel(), (base + 2 * head_dim).ravel()


def _falcon_rows(n_head: int, n_head_kv: int, head_dim: int):
    q = np.arange(n_head * head_dim)
    k = n_head * head_dim + np.arange(n_head_kv * head_dim)
    v = (n_head + n_head_kv) * head_dim + np.arange(n_head_kv * head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# per-arch parameter builders


def _build_llama(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    layers = []
    for i in range(spec.n_layer):
        p = f"layers.{i}"
        layers.append(
            LayerParams(
                ln1_w=ws.vec(f"{p}.attention_norm.weight"),
                ln1_b=None,
                ln2_w=ws.vec(f"{p}.ffn_norm.weight"),
                ln2_b=None,
                wq=ws.matrix(f"{p}.attention.wq.weight"),
                bq=None,
                wk=ws.matrix(f"{p}.attention.wk.weight"),
                bk=None,
                wv=ws.matrix(f"{p}.attention.wv.weight"),
                bv=None,
                wo=ws.matrix(f"{p}.attention.wo.weight"),
                bo=None,
                w_gate=ws.matrix(f"{p}.feed_forward.w1.weight"),
                w_up=ws.matrix(f"{p}.feed_forward.w3.weight"),
                b_up=None,
                w_down=ws.matrix(f"{p}.feed_forward.w2.weight"),
                b_down=None,
            )
        )
    return ModelParams(
        wte=ws.matrix("tok_embeddings.weight"),
        wpe=None,
        emb_norm_w=None,
        emb_norm_b=None,
        final_norm_w=ws.vec("norm.weight"),
        final_norm_b=None,
        lm_head=ws.matrix("output.weight"),
        lm_head_b=None,
        layers=stack_layers(layers),
    )


def _build_gpt2(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    q, k, v = _thirds(spec.n_embd)
    layers = []
    for i in range(spec.n_layer):
        p = f"model/h{i}"
        layers.append(
            LayerParams(
                ln1_w=ws.vec(f"{p}/ln_1/g"),
                ln1_b=ws.vec(f"{p}/ln_1/b"),
                ln2_w=ws.vec(f"{p}/ln_2/g"),
                ln2_b=ws.vec(f"{p}/ln_2/b"),
                wq=ws.matrix(f"{p}/attn/c_attn/w", rows=q),
                bq=ws.vec(f"{p}/attn/c_attn/b", rows=q),
                wk=ws.matrix(f"{p}/attn/c_attn/w", rows=k),
                bk=ws.vec(f"{p}/attn/c_attn/b", rows=k),
                wv=ws.matrix(f"{p}/attn/c_attn/w", rows=v),
                bv=ws.vec(f"{p}/attn/c_attn/b", rows=v),
                wo=ws.matrix(f"{p}/attn/c_proj/w"),
                bo=ws.vec(f"{p}/attn/c_proj/b"),
                w_gate=None,
                w_up=ws.matrix(f"{p}/mlp/c_fc/w"),
                b_up=ws.vec(f"{p}/mlp/c_fc/b"),
                w_down=ws.matrix(f"{p}/mlp/c_proj/w"),
                b_down=ws.vec(f"{p}/mlp/c_proj/b"),
            )
        )
    return ModelParams(
        wte=ws.matrix("model/wte"),
        wpe=ws.matrix("model/wpe"),
        emb_norm_w=None,
        emb_norm_b=None,
        final_norm_w=ws.vec("model/ln_f/g"),
        final_norm_b=ws.vec("model/ln_f/b"),
        lm_head=ws.maybe_matrix("model/lm_head"),
        lm_head_b=None,
        layers=stack_layers(layers),
    )


def _build_gptj(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    layers = []
    for i in range(spec.n_layer):
        p = f"transformer.h.{i}"
        layers.append(
            LayerParams(
                ln1_w=ws.vec(f"{p}.ln_1.weight"),
                ln1_b=ws.vec(f"{p}.ln_1.bias"),
                ln2_w=None,
                ln2_b=None,
                wq=ws.matrix(f"{p}.attn.q_proj.weight"),
                bq=None,
                wk=ws.matrix(f"{p}.attn.k_proj.weight"),
                bk=None,
                wv=ws.matrix(f"{p}.attn.v_proj.weight"),
                bv=None,
                wo=ws.matrix(f"{p}.attn.out_proj.weight"),
                bo=None,
                w_gate=None,
                w_up=ws.matrix(f"{p}.mlp.fc_in.weight"),
                b_up=ws.vec(f"{p}.mlp.fc_in.bias"),
                w_down=ws.matrix(f"{p}.mlp.fc_out.weight"),
                b_down=ws.vec(f"{p}.mlp.fc_out.bias"),
            )
        )
    return ModelParams(
        wte=ws.matrix("transformer.wte.weight"),
        wpe=None,
        emb_norm_w=None,
        emb_norm_b=None,
        final_norm_w=ws.vec("transformer.ln_f.weight"),
        final_norm_b=ws.vec("transformer.ln_f.bias"),
        lm_head=ws.matrix("lm_head.weight"),
        lm_head_b=ws.vec("lm_head.bias"),
        layers=stack_layers(layers),
    )


def _build_gptneox(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    q, k, v = _neox_interleaved(spec.n_head, spec.head_dim)
    layers = []
    for i in range(spec.n_layer):
        p = f"gpt_neox.layers.{i}"
        layers.append(
            LayerParams(
                ln1_w=ws.vec(f"{p}.input_layernorm.weight"),
                ln1_b=ws.vec(f"{p}.input_layernorm.bias"),
                ln2_w=ws.vec(f"{p}.post_attention_layernorm.weight"),
                ln2_b=ws.vec(f"{p}.post_attention_layernorm.bias"),
                wq=ws.matrix(f"{p}.attention.query_key_value.weight", rows=q),
                bq=ws.vec(f"{p}.attention.query_key_value.bias", rows=q),
                wk=ws.matrix(f"{p}.attention.query_key_value.weight", rows=k),
                bk=ws.vec(f"{p}.attention.query_key_value.bias", rows=k),
                wv=ws.matrix(f"{p}.attention.query_key_value.weight", rows=v),
                bv=ws.vec(f"{p}.attention.query_key_value.bias", rows=v),
                wo=ws.matrix(f"{p}.attention.dense.weight"),
                bo=ws.vec(f"{p}.attention.dense.bias"),
                w_gate=None,
                w_up=ws.matrix(f"{p}.mlp.dense_h_to_4h.weight"),
                b_up=ws.vec(f"{p}.mlp.dense_h_to_4h.bias"),
                w_down=ws.matrix(f"{p}.mlp.dense_4h_to_h.weight"),
                b_down=ws.vec(f"{p}.mlp.dense_4h_to_h.bias"),
            )
        )
    return ModelParams(
        wte=ws.matrix("gpt_neox.embed_in.weight"),
        wpe=None,
        emb_norm_w=None,
        emb_norm_b=None,
        final_norm_w=ws.vec("gpt_neox.final_layer_norm.weight"),
        final_norm_b=ws.vec("gpt_neox.final_layer_norm.bias"),
        lm_head=ws.matrix("embed_out.weight"),
        lm_head_b=None,
        layers=stack_layers(layers),
    )


def _build_bloom(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    q, k, v = _thirds(spec.n_embd)
    layers = []
    for i in range(spec.n_layer):
        p = f"layers.{i}"
        layers.append(
            LayerParams(
                ln1_w=ws.vec(f"{p}.attention_norm.weight"),
                ln1_b=ws.vec(f"{p}.attention_norm.bias"),
                ln2_w=ws.vec(f"{p}.ffn_norm.weight"),
                ln2_b=ws.vec(f"{p}.ffn_norm.bias"),
                wq=ws.matrix(f"{p}.attention.query_key_value.weight", rows=q),
                bq=ws.vec(f"{p}.attention.query_key_value.bias", rows=q),
                wk=ws.matrix(f"{p}.attention.query_key_value.weight", rows=k),
                bk=ws.vec(f"{p}.attention.query_key_value.bias", rows=k),
                wv=ws.matrix(f"{p}.attention.query_key_value.weight", rows=v),
                bv=ws.vec(f"{p}.attention.query_key_value.bias", rows=v),
                wo=ws.matrix(f"{p}.attention.wo.weight"),
                bo=ws.vec(f"{p}.attention.wo.bias"),
                w_gate=None,
                w_up=ws.matrix(f"{p}.feed_forward.w1.weight"),
                b_up=ws.vec(f"{p}.feed_forward.w1.bias"),
                w_down=ws.matrix(f"{p}.feed_forward.w2.weight"),
                b_down=ws.vec(f"{p}.feed_forward.w2.bias"),
            )
        )
    return ModelParams(
        wte=ws.matrix("tok_embeddings.weight"),
        wpe=None,
        emb_norm_w=ws.vec("norm.weight"),
        emb_norm_b=ws.vec("norm.bias"),
        final_norm_w=ws.vec("output_norm.weight"),
        final_norm_b=ws.vec("output_norm.bias"),
        lm_head=ws.matrix("output.weight"),
        lm_head_b=None,
        layers=stack_layers(layers),
    )


def _build_mpt(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    q, k, v = _thirds(spec.n_embd)
    layers = []
    for i in range(spec.n_layer):
        p = f"transformer.blocks.{i}"
        layers.append(
            LayerParams(
                ln1_w=ws.vec(f"{p}.norm_1.weight"),
                ln1_b=None,
                ln2_w=ws.vec(f"{p}.norm_2.weight"),
                ln2_b=None,
                wq=ws.matrix(f"{p}.attn.Wqkv.weight", rows=q),
                bq=None,
                wk=ws.matrix(f"{p}.attn.Wqkv.weight", rows=k),
                bk=None,
                wv=ws.matrix(f"{p}.attn.Wqkv.weight", rows=v),
                bv=None,
                wo=ws.matrix(f"{p}.attn.out_proj.weight"),
                bo=None,
                w_gate=None,
                w_up=ws.matrix(f"{p}.ffn.up_proj.weight"),
                b_up=None,
                w_down=ws.matrix(f"{p}.ffn.down_proj.weight"),
                b_down=None,
            )
        )
    return ModelParams(
        wte=ws.matrix("transformer.wte.weight"),
        wpe=None,
        emb_norm_w=None,
        emb_norm_b=None,
        final_norm_w=ws.vec("transformer.norm_f.weight"),
        final_norm_b=None,
        lm_head=None,  # tied (mpt/src/lib.rs:243-244)
        lm_head_b=None,
        layers=stack_layers(layers),
    )


def _build_falcon(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    q, k, v = _falcon_rows(spec.n_head, spec.n_head_kv, spec.head_dim)
    layers = []
    for i in range(spec.n_layer):
        p = f"transformer.h.{i}"
        if spec.n_head_kv == 1:  # falcon 7B: single shared LN
            ln1_w = ws.vec(f"{p}.input_layernorm.weight")
            ln1_b = ws.vec(f"{p}.input_layernorm.bias")
            ln2_w = ln2_b = None
        else:  # falcon 40B: ln_attn feeds attention, ln_mlp feeds the FFN
            ln1_w = ws.vec(f"{p}.ln_attn.weight")
            ln1_b = ws.vec(f"{p}.ln_attn.bias")
            ln2_w = ws.vec(f"{p}.ln_mlp.weight")
            ln2_b = ws.vec(f"{p}.ln_mlp.bias")
        layers.append(
            LayerParams(
                ln1_w=ln1_w,
                ln1_b=ln1_b,
                ln2_w=ln2_w,
                ln2_b=ln2_b,
                wq=ws.matrix(f"{p}.self_attention.query_key_value.weight", rows=q),
                bq=None,
                wk=ws.matrix(f"{p}.self_attention.query_key_value.weight", rows=k),
                bk=None,
                wv=ws.matrix(f"{p}.self_attention.query_key_value.weight", rows=v),
                bv=None,
                wo=ws.matrix(f"{p}.self_attention.dense.weight"),
                bo=None,
                w_gate=None,
                w_up=ws.matrix(f"{p}.mlp.dense_h_to_4h.weight"),
                b_up=None,
                w_down=ws.matrix(f"{p}.mlp.dense_4h_to_h.weight"),
                b_down=None,
            )
        )
    return ModelParams(
        wte=ws.matrix("transformer.word_embeddings.weight"),
        wpe=None,
        emb_norm_w=None,
        emb_norm_b=None,
        final_norm_w=ws.vec("transformer.ln_f.weight"),
        final_norm_b=ws.vec("transformer.ln_f.bias"),
        lm_head=ws.matrix("lm_head.weight"),
        lm_head_b=None,
        layers=stack_layers(layers),
    )


_BUILDERS = {
    "llama": _build_llama,
    "gpt2": _build_gpt2,
    "gptj": _build_gptj,
    "gptneox": _build_gptneox,
    "bloom": _build_bloom,
    "mpt": _build_mpt,
    "falcon": _build_falcon,
}


def build_params(ws: WeightSource, spec: ModelSpec) -> ModelParams:
    """The model's parameters on the source's device, with the dense-upcast
    gate applied (off unless LLM_TPU_DENSE_UPCAST asks for it)."""
    return maybe_upcast_dense(_BUILDERS[spec.arch](ws, spec))


# ---------------------------------------------------------------------------
# weight carry from the JAX package


def _weight_from_numpy(v, device):
    """One leaf of the carried tree -> torch (QuantTensor, tensor or None).

    A quantized weight arrives as a dict with `fmt_name`, `k`, `r`,
    `splits` and numpy planes `lo`/`hi`/`scale`/`bias`, or, for the
    coalesced layout, the buffer `buf` with `kp`, `rp`, `tile_k`, `tile_r`
    and `scale_packed` (uint32 words keep their bits as int32)."""
    if v is None:
        return None
    if isinstance(v, dict):

        def t(a):
            if a is None:
                return None
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            return torch.from_numpy(np.array(a)).to(device)

        splits = v.get("splits")
        if "buf" in v:
            return QuantTensorC(
                v["fmt_name"], int(v["k"]), int(v["r"]), int(v["kp"]),
                int(v["rp"]), int(v["tile_k"]), int(v["tile_r"]),
                bool(v["scale_packed"]), t(v["buf"]),
                tuple(map(tuple, splits)) if splits else None)
        return QuantTensor(v["fmt_name"], int(v["k"]), int(v["r"]),
                           t(v["lo"]), t(v.get("hi")), t(v["scale"]),
                           t(v.get("bias")),
                           tuple(map(tuple, splits)) if splits else None)
    return torch.from_numpy(np.array(v)).to(device)


def params_from_numpy(tree: dict, device) -> ModelParams:
    """ModelParams from a nested dict of numpy arrays: the field names of
    ModelParams, with `layers` a dict of the LayerParams fields (each
    stacked along a leading layer axis). This is how weights packed by the
    JAX package are carried into the port."""
    device = torch.device(device)
    layers = LayerParams(**{
        f.name: _weight_from_numpy(tree["layers"].get(f.name), device)
        for f in fields(LayerParams)
    })
    kw = {f.name: _weight_from_numpy(tree.get(f.name), device)
          for f in fields(ModelParams) if f.name != "layers"}
    return ModelParams(layers=layers, **kw)
