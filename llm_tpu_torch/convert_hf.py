"""HuggingFace checkpoint -> GGML/GGUF converter (all 7 architectures).

The counterpart of `llm_tpu/convert_hf.py`: the same files, byte for byte.
`transformers` is imported only to open a `from_pretrained` directory; an
in-memory model needs nothing beyond torch.

The on-ramp the reference leaves to external scripts: rustformers/llm only
CONSUMES GGML-family files and points users at the llama.cpp-era converter
scripts (llm/doc/known-good-models.md, README "Getting models").
This module is that converter, built into the framework: it takes a
`transformers` model (an in-memory ``PreTrainedModel`` or a local
``from_pretrained`` directory) and writes a classic GGJT v3 — or GGUF v3 —
checkpoint that `llm_tpu_torch.loader.load` (and the reference CLI) can
read.

Per-architecture weight transforms (the part the llama.cpp converters
encode, mirrored here and logit-parity-tested in tests/test_convert_hf.py):

- gpt2: Conv1D weights are stored [in, out] and must be transposed to the
  row-major [out, in] a ggml matmul expects; the lm_head is omitted when
  tied to wte (the reference graph falls back to wte,
  llm/crates/models/gpt2/src/lib.rs:66-73,319-320).
- llama/mistral: q/k projections are permuted from HF "rotate_half" order
  to interleaved-pair RoPE order, each with ITS OWN head count so grouped
  -query checkpoints (70B, Mistral) convert correctly.
- bloom: the fused qkv interleaves [head, {q,k,v}, head_dim] rows in HF;
  the ggml graph expects contiguous thirds
  (llm/crates/models/bloom/src/lib.rs:167-185).
- falcon (new_decoder_architecture): HF packs qkv per kv-group
  [q x H/kv, k, v]; the ggml graph expects [q x H, k x kv, v x kv]
  (llm/crates/models/falcon/src/lib.rs:220-241).
- gptj / gptneox / mpt / falcon-7B(MQA): direct copies (HF layouts already
  match what the reference graphs consume).

``ftype="f16"`` stores 2-D tensors matching the architecture's quantize
patterns as F16 (same per-tensor rule as the quantizer,
llm/crates/llm-base/src/quantize.rs:332-335); everything else
stays F32. Quantize further with ``llm-tpu-torch quantize`` (any Q*_0/Q*_1/Q*_K
target).

Vocabulary: scores are not recoverable from fast tokenizers, so embedded
vocab entries carry score 0.0 (like the llama.cpp BPE path); pass the HF
tokenizer at load time (``--tokenizer``) for exact tokenization. Token ids
absent from the tokenizer map are written as ``<unused{i}>`` placeholders.
"""

from __future__ import annotations

import io
import os
import tempfile
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from llm_tpu_torch.ggml.types import (
    ContainerType,
    FileType,
    FileTypeFormat,
    GgmlType,
)
from llm_tpu_torch.ggml.writer import GgmlWriter
from llm_tpu_torch.models.spec import Hyperparameters, get_arch

# HF config.model_type -> framework architecture name
MODEL_TYPE_TO_ARCH = {
    "gpt2": "gpt2",
    "llama": "llama",
    "mistral": "llama",  # llama graph; sliding-window attn not encoded
    "gptj": "gptj",
    "gpt_neox": "gptneox",
    "bloom": "bloom",
    "mpt": "mpt",
    "falcon": "falcon",
    "RefinedWeb": "falcon",
    "RefinedWebModel": "falcon",
}


class ConvertError(ValueError):
    pass


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _permute_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF 'rotate_half' row order -> interleaved-pair RoPE order (inverse
    of llama.cpp convert.py's import permutation). Rows [n_head, 2, hd/2]
    -> [n_head, hd/2, 2]."""
    out = w.shape[0]
    return (
        w.reshape(n_head, 2, out // n_head // 2, *w.shape[1:])
        .swapaxes(1, 2)
        .reshape(w.shape)
    )


def _is_tied(model) -> bool:
    try:
        head = model.get_output_embeddings()
        emb = model.get_input_embeddings()
        return head is None or head.weight is emb.weight
    except Exception:
        return False


# --- per-architecture tensor streams ---------------------------------------
# Each yields (ggml_name, np.ndarray) with arrays in row-major [R, K]
# (= torch Linear [out, in]); _write_file reverses dims for the container.


def _conv_gpt2(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()

    def stream():
        yield "model/wte", _np(sd["transformer.wte.weight"])
        yield "model/wpe", _np(sd["transformer.wpe.weight"])
        yield "model/ln_f/g", _np(sd["transformer.ln_f.weight"])
        yield "model/ln_f/b", _np(sd["transformer.ln_f.bias"])
        if not _is_tied(model):
            yield "model/lm_head", _np(sd["lm_head.weight"])
        for i in range(cfg.n_layer):
            hf, g = f"transformer.h.{i}", f"model/h{i}"
            yield f"{g}/ln_1/g", _np(sd[f"{hf}.ln_1.weight"])
            yield f"{g}/ln_1/b", _np(sd[f"{hf}.ln_1.bias"])
            yield f"{g}/ln_2/g", _np(sd[f"{hf}.ln_2.weight"])
            yield f"{g}/ln_2/b", _np(sd[f"{hf}.ln_2.bias"])
            # Conv1D stores [in, out]; ggml wants row-major [out, in]
            yield f"{g}/attn/c_attn/w", _np(sd[f"{hf}.attn.c_attn.weight"]).T
            yield f"{g}/attn/c_attn/b", _np(sd[f"{hf}.attn.c_attn.bias"])
            yield f"{g}/attn/c_proj/w", _np(sd[f"{hf}.attn.c_proj.weight"]).T
            yield f"{g}/attn/c_proj/b", _np(sd[f"{hf}.attn.c_proj.bias"])
            yield f"{g}/mlp/c_fc/w", _np(sd[f"{hf}.mlp.c_fc.weight"]).T
            yield f"{g}/mlp/c_fc/b", _np(sd[f"{hf}.mlp.c_fc.bias"])
            yield f"{g}/mlp/c_proj/w", _np(sd[f"{hf}.mlp.c_proj.weight"]).T
            yield f"{g}/mlp/c_proj/b", _np(sd[f"{hf}.mlp.c_proj.bias"])

    h = Hyperparameters(
        arch="gpt2", n_vocab=cfg.vocab_size, n_ctx=cfg.n_positions,
        n_embd=cfg.n_embd, n_head=cfg.n_head, n_layer=cfg.n_layer,
    )
    return h, stream()


def _conv_llama(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()
    n_head = cfg.num_attention_heads
    n_kv = getattr(cfg, "num_key_value_heads", None) or n_head
    hd = cfg.hidden_size // n_head

    def stream():
        yield "tok_embeddings.weight", _np(sd["model.embed_tokens.weight"])
        yield "norm.weight", _np(sd["model.norm.weight"])
        if getattr(cfg, "tie_word_embeddings", False):
            yield "output.weight", _np(sd["model.embed_tokens.weight"])
        else:
            yield "output.weight", _np(sd["lm_head.weight"])
        for i in range(cfg.num_hidden_layers):
            hf, g = f"model.layers.{i}", f"layers.{i}"
            yield (f"{g}.attention_norm.weight",
                   _np(sd[f"{hf}.input_layernorm.weight"]))
            # q and k permute with their OWN head counts (GQA/Mistral)
            yield (f"{g}.attention.wq.weight",
                   _permute_rope(_np(sd[f"{hf}.self_attn.q_proj.weight"]),
                                 n_head))
            yield (f"{g}.attention.wk.weight",
                   _permute_rope(_np(sd[f"{hf}.self_attn.k_proj.weight"]),
                                 n_kv))
            yield (f"{g}.attention.wv.weight",
                   _np(sd[f"{hf}.self_attn.v_proj.weight"]))
            yield (f"{g}.attention.wo.weight",
                   _np(sd[f"{hf}.self_attn.o_proj.weight"]))
            yield (f"{g}.ffn_norm.weight",
                   _np(sd[f"{hf}.post_attention_layernorm.weight"]))
            yield (f"{g}.feed_forward.w1.weight",
                   _np(sd[f"{hf}.mlp.gate_proj.weight"]))
            yield (f"{g}.feed_forward.w2.weight",
                   _np(sd[f"{hf}.mlp.down_proj.weight"]))
            yield (f"{g}.feed_forward.w3.weight",
                   _np(sd[f"{hf}.mlp.up_proj.weight"]))

    # n_mult is cosmetic for this loader (n_ff comes from tensor shapes);
    # 256 matches the original llama.cpp export convention
    h = Hyperparameters(
        arch="llama", n_vocab=cfg.vocab_size, n_embd=cfg.hidden_size,
        n_mult=256, n_head=n_head, n_head_kv=n_kv,
        n_layer=cfg.num_hidden_layers, n_rot=hd,
    )
    return h, stream()


def _conv_gptj(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()

    def stream():
        yield "transformer.wte.weight", _np(sd["transformer.wte.weight"])
        yield "transformer.ln_f.weight", _np(sd["transformer.ln_f.weight"])
        yield "transformer.ln_f.bias", _np(sd["transformer.ln_f.bias"])
        yield "lm_head.weight", _np(sd["lm_head.weight"])
        yield "lm_head.bias", _np(sd["lm_head.bias"])
        for i in range(cfg.n_layer):
            hf = f"transformer.h.{i}"
            for n in ("ln_1.weight", "ln_1.bias",
                      "attn.q_proj.weight", "attn.k_proj.weight",
                      "attn.v_proj.weight", "attn.out_proj.weight",
                      "mlp.fc_in.weight", "mlp.fc_in.bias",
                      "mlp.fc_out.weight", "mlp.fc_out.bias"):
                yield f"{hf}.{n}", _np(sd[f"{hf}.{n}"])

    h = Hyperparameters(
        arch="gptj", n_vocab=cfg.vocab_size, n_ctx=cfg.n_positions,
        n_embd=cfg.n_embd, n_head=cfg.n_head, n_layer=cfg.n_layer,
        n_rot=cfg.rotary_dim,
    )
    return h, stream()


def _conv_gptneox(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()
    hd = cfg.hidden_size // cfg.num_attention_heads

    def stream():
        yield "gpt_neox.embed_in.weight", _np(sd["gpt_neox.embed_in.weight"])
        yield ("gpt_neox.final_layer_norm.weight",
               _np(sd["gpt_neox.final_layer_norm.weight"]))
        yield ("gpt_neox.final_layer_norm.bias",
               _np(sd["gpt_neox.final_layer_norm.bias"]))
        yield "embed_out.weight", _np(sd["embed_out.weight"])
        for i in range(cfg.num_hidden_layers):
            hf = f"gpt_neox.layers.{i}"
            for n in ("input_layernorm.weight", "input_layernorm.bias",
                      "post_attention_layernorm.weight",
                      "post_attention_layernorm.bias",
                      "attention.query_key_value.weight",
                      "attention.query_key_value.bias",
                      "attention.dense.weight", "attention.dense.bias",
                      "mlp.dense_h_to_4h.weight", "mlp.dense_h_to_4h.bias",
                      "mlp.dense_4h_to_h.weight", "mlp.dense_4h_to_h.bias"):
                yield f"{hf}.{n}", _np(sd[f"{hf}.{n}"])

    h = Hyperparameters(
        arch="gptneox", n_vocab=cfg.vocab_size,
        n_ctx=cfg.max_position_embeddings, n_embd=cfg.hidden_size,
        n_head=cfg.num_attention_heads, n_layer=cfg.num_hidden_layers,
        n_rot=int(hd * cfg.rotary_pct),
        use_parallel_residual=cfg.use_parallel_residual,
    )
    return h, stream()


def _conv_bloom(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()
    n_head = cfg.n_head
    hd = cfg.hidden_size // n_head

    def reorder(w: np.ndarray) -> np.ndarray:
        # HF rows: [head, {q,k,v}, head_dim] -> contiguous q|k|v thirds
        x = w.reshape(n_head, 3, hd, *w.shape[1:])
        return np.concatenate([x[:, 0], x[:, 1], x[:, 2]], axis=0).reshape(
            w.shape
        )

    def stream():
        emb = _np(sd["transformer.word_embeddings.weight"])
        yield "tok_embeddings.weight", emb
        yield ("norm.weight",
               _np(sd["transformer.word_embeddings_layernorm.weight"]))
        yield ("norm.bias",
               _np(sd["transformer.word_embeddings_layernorm.bias"]))
        yield "output_norm.weight", _np(sd["transformer.ln_f.weight"])
        yield "output_norm.bias", _np(sd["transformer.ln_f.bias"])
        yield "output.weight", emb  # bloom head is tied
        for i in range(cfg.n_layer):
            hf, g = f"transformer.h.{i}", f"layers.{i}"
            yield (f"{g}.attention_norm.weight",
                   _np(sd[f"{hf}.input_layernorm.weight"]))
            yield (f"{g}.attention_norm.bias",
                   _np(sd[f"{hf}.input_layernorm.bias"]))
            yield (f"{g}.attention.query_key_value.weight",
                   reorder(_np(sd[f"{hf}.self_attention.query_key_value.weight"])))
            yield (f"{g}.attention.query_key_value.bias",
                   reorder(_np(sd[f"{hf}.self_attention.query_key_value.bias"])))
            yield (f"{g}.attention.wo.weight",
                   _np(sd[f"{hf}.self_attention.dense.weight"]))
            yield (f"{g}.attention.wo.bias",
                   _np(sd[f"{hf}.self_attention.dense.bias"]))
            yield (f"{g}.ffn_norm.weight",
                   _np(sd[f"{hf}.post_attention_layernorm.weight"]))
            yield (f"{g}.ffn_norm.bias",
                   _np(sd[f"{hf}.post_attention_layernorm.bias"]))
            yield (f"{g}.feed_forward.w1.weight",
                   _np(sd[f"{hf}.mlp.dense_h_to_4h.weight"]))
            yield (f"{g}.feed_forward.w1.bias",
                   _np(sd[f"{hf}.mlp.dense_h_to_4h.bias"]))
            yield (f"{g}.feed_forward.w2.weight",
                   _np(sd[f"{hf}.mlp.dense_4h_to_h.weight"]))
            yield (f"{g}.feed_forward.w2.bias",
                   _np(sd[f"{hf}.mlp.dense_4h_to_h.bias"]))

    h = Hyperparameters(
        arch="bloom", n_vocab=cfg.vocab_size, n_embd=cfg.hidden_size,
        n_mult=256, n_head=n_head, n_layer=cfg.n_layer,
    )
    return h, stream()


def _conv_mpt(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()
    attn = cfg.attn_config

    def stream():
        yield "transformer.wte.weight", _np(sd["transformer.wte.weight"])
        yield "transformer.norm_f.weight", _np(sd["transformer.norm_f.weight"])
        for i in range(cfg.n_layers):
            hf = f"transformer.blocks.{i}"
            for n in ("norm_1.weight", "attn.Wqkv.weight",
                      "attn.out_proj.weight", "norm_2.weight",
                      "ffn.up_proj.weight", "ffn.down_proj.weight"):
                yield f"{hf}.{n}", _np(sd[f"{hf}.{n}"])

    clip = getattr(attn, "clip_qkv", None)
    h = Hyperparameters(
        arch="mpt", n_vocab=cfg.vocab_size, n_embd=cfg.d_model,
        n_head=cfg.n_heads, n_layer=cfg.n_layers,
        max_seq_len=cfg.max_seq_len,
        alibi_bias_max=float(getattr(attn, "alibi_bias_max", 8) or 8),
        clip_kqv=float(clip) if clip else 0.0,
    )
    return h, stream()


def _conv_falcon(model, cfg) -> tuple[Hyperparameters, Iterator]:
    sd = model.state_dict()
    n_head = cfg.num_attention_heads
    hd = cfg.hidden_size // n_head
    new_arch = bool(getattr(cfg, "new_decoder_architecture", False))
    if new_arch:
        kv = cfg.num_kv_heads
    else:
        if not getattr(cfg, "multi_query", True):
            # Old-architecture MHA falcon (e.g. falcon-rw-1b): HF packs the
            # fused qkv per head [head, {q,k,v}, hd] (bloom-style), NOT the
            # contiguous [q x H, k, v] this graph consumes — and the loader
            # keys the 40B dual-LN residual off n_head_kv != 1, so the
            # converted file would produce silently wrong logits.
            raise ConvertError(
                "falcon with new_decoder_architecture=False and "
                "multi_query=False (RefinedWeb MHA layout, e.g. "
                "falcon-rw-1b) is not convertible: the graph only supports "
                "the 7B MQA and 40B group-packed qkv layouts"
            )
        kv = 1

    def reorder40(w: np.ndarray) -> np.ndarray:
        # HF per-kv-group [q x H/kv, k, v] -> [q x H, k x kv, v x kv]
        x = w.reshape(kv, n_head // kv + 2, hd, w.shape[-1])
        q = x[:, : n_head // kv].reshape(n_head * hd, -1)
        k = x[:, n_head // kv].reshape(kv * hd, -1)
        v = x[:, n_head // kv + 1].reshape(kv * hd, -1)
        return np.concatenate([q, k, v], axis=0)

    def stream():
        yield ("transformer.word_embeddings.weight",
               _np(sd["transformer.word_embeddings.weight"]))
        yield "transformer.ln_f.weight", _np(sd["transformer.ln_f.weight"])
        yield "transformer.ln_f.bias", _np(sd["transformer.ln_f.bias"])
        if _is_tied(model):
            yield ("lm_head.weight",
                   _np(sd["transformer.word_embeddings.weight"]))
        else:
            yield "lm_head.weight", _np(sd["lm_head.weight"])
        for i in range(cfg.num_hidden_layers):
            hf = f"transformer.h.{i}"
            if new_arch:  # 40B layout: dual pre-norms
                yield f"{hf}.ln_attn.weight", _np(sd[f"{hf}.ln_attn.weight"])
                yield f"{hf}.ln_attn.bias", _np(sd[f"{hf}.ln_attn.bias"])
                yield f"{hf}.ln_mlp.weight", _np(sd[f"{hf}.ln_mlp.weight"])
                yield f"{hf}.ln_mlp.bias", _np(sd[f"{hf}.ln_mlp.bias"])
                yield (f"{hf}.self_attention.query_key_value.weight",
                       reorder40(_np(
                           sd[f"{hf}.self_attention.query_key_value.weight"])))
            else:  # 7B MQA layout: qkv already [q x H, k, v]
                yield (f"{hf}.input_layernorm.weight",
                       _np(sd[f"{hf}.input_layernorm.weight"]))
                yield (f"{hf}.input_layernorm.bias",
                       _np(sd[f"{hf}.input_layernorm.bias"]))
                yield (f"{hf}.self_attention.query_key_value.weight",
                       _np(sd[f"{hf}.self_attention.query_key_value.weight"]))
            yield (f"{hf}.self_attention.dense.weight",
                   _np(sd[f"{hf}.self_attention.dense.weight"]))
            yield (f"{hf}.mlp.dense_h_to_4h.weight",
                   _np(sd[f"{hf}.mlp.dense_h_to_4h.weight"]))
            yield (f"{hf}.mlp.dense_4h_to_h.weight",
                   _np(sd[f"{hf}.mlp.dense_4h_to_h.weight"]))

    h = Hyperparameters(
        arch="falcon", n_vocab=cfg.vocab_size, n_embd=cfg.hidden_size,
        n_head=n_head, n_head_kv=kv, n_layer=cfg.num_hidden_layers,
    )
    return h, stream()


_CONVERTERS: dict[str, Callable] = {
    "gpt2": _conv_gpt2,
    "llama": _conv_llama,
    "gptj": _conv_gptj,
    "gptneox": _conv_gptneox,
    "bloom": _conv_bloom,
    "mpt": _conv_mpt,
    "falcon": _conv_falcon,
}


# --- vocabulary -------------------------------------------------------------


def placeholder_vocab(n_vocab: int) -> list[tuple[bytes, float]]:
    return [(f"<unused{i}>".encode(), 0.0) for i in range(n_vocab)]


def vocab_from_tokenizer(
    tok, n_vocab: int, *, surface: bool = False
) -> list[tuple[bytes, float]]:
    """Embedded scored vocab from an HF tokenizer, score 0.0 (fast
    tokenizers do not expose SentencePiece scores).

    By default tokens are mapped back to the RAW BYTES the embedded
    tokenizer emits on decode (the classic-container vocab is
    byte-oriented), mirroring the llama.cpp converters: byte-level BPE
    vocabularies (gpt2 family, surface forms like 'Ġhello') run through
    the gpt2 byte-decoder; SentencePiece-style vocabularies replace the
    U+2581 word-boundary marker with a space and decode literal '<0xNN>'
    byte tokens. Without this, converted classic checkpoints decode to
    mojibake (Ġ/▁ characters, literal '<0xNA>' text).

    ``surface=True`` keeps the tokenizer's surface forms verbatim — the
    GGUF convention (tokenizer.ggml.tokens stores mapped/marked forms;
    the loader's BPE/SentencePiece paths undo them at load time)."""
    import re

    from llm_tpu_torch.tokenizer.bpe import _U2B

    by_id: dict[int, str] = {}
    try:
        for s, i in tok.get_vocab().items():
            by_id[int(i)] = s
    except Exception:
        return placeholder_vocab(n_vocab)

    # Decide the surface-form family GLOBALLY (per-token guessing would
    # mis-map latin-1-looking SentencePiece tokens like 'é' through the
    # byte alphabet): 'Ġ' (U+0120, byte-mapped space) marks byte-level
    # BPE; '▁' (U+2581) marks SentencePiece.
    vals = by_id.values()
    byte_level = any("Ġ" in s for s in vals) and not any(
        "▁" in s for s in vals
    )
    byte_tok = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")

    def to_bytes(s: str) -> bytes:
        if surface:
            return s.encode()
        if byte_level:
            if all(ch in _U2B for ch in s):
                return bytes(_U2B[ch] for ch in s)
            return s.encode()  # added special tokens live outside the alphabet
        m = byte_tok.match(s)
        if m:
            return bytes([int(m.group(1), 16)])
        return s.replace("▁", " ").encode()

    out = []
    for i in range(n_vocab):
        s = by_id.get(i)
        out.append((to_bytes(s) if s is not None else f"<unused{i}>".encode(),
                    0.0))
    return out


# --- entry points -----------------------------------------------------------


def convert_hf(
    model,
    output: str | Path,
    *,
    architecture: Optional[str] = None,
    ftype: str = "f32",
    tokenizer=None,
    gguf: bool = False,
    tokenizer_json: Optional[str | Path] = None,
    progress: Optional[Callable[[str], None]] = None,
) -> str:
    """Convert `model` (a transformers PreTrainedModel or a local
    from_pretrained path) to a GGJT v3 file at `output` (or GGUF v3 with
    ``gguf=True``). Returns the detected architecture name."""
    if ftype not in ("f32", "f16"):
        raise ConvertError(f"unsupported ftype {ftype!r} (f32 or f16)")
    if isinstance(model, (str, Path)):
        path = str(model)
        import transformers

        if tokenizer is None:
            try:
                tokenizer = transformers.AutoTokenizer.from_pretrained(path)
            except Exception:
                tokenizer = None
        model = transformers.AutoModelForCausalLM.from_pretrained(path)
    cfg = model.config
    arch = architecture or MODEL_TYPE_TO_ARCH.get(
        getattr(cfg, "model_type", ""))
    if arch not in _CONVERTERS:
        raise ConvertError(
            f"unsupported HF model_type {getattr(cfg, 'model_type', None)!r}"
            f" (architectures: {sorted(_CONVERTERS)})"
        )
    hparams, tensors = _CONVERTERS[arch](model, cfg)
    if (
        not gguf
        and arch != "falcon"  # falcon's classic codec carries n_head_kv
        and hparams.n_head_kv
        and hparams.n_head_kv != hparams.n_head
        and not (arch == "llama" and hparams.n_layer >= 80)
    ):
        # Classic hparams cannot encode GQA: the loader would assume
        # n_head_kv == n_head and produce garbage logits. (The --n-gqa
        # load-time escape hatch only applies to llama with n_layer >= 80,
        # matching the reference's 70B assert, lib.rs:107-117.)
        raise ConvertError(
            f"{arch} checkpoint has grouped-query attention "
            f"(n_head_kv={hparams.n_head_kv} != n_head={hparams.n_head}), "
            "which the classic GGJT container cannot encode — convert with "
            "gguf=True (CLI: --gguf) instead"
        )
    vocab = (vocab_from_tokenizer(tokenizer, hparams.n_vocab, surface=gguf)
             if tokenizer is not None
             else placeholder_vocab(hparams.n_vocab))

    if gguf:
        from llm_tpu_torch.ggml.gguf import convert_ggml_to_gguf

        with tempfile.NamedTemporaryFile(
            suffix=".bin", dir=os.path.dirname(os.path.abspath(output)),
            delete=False,
        ) as tmp:
            tmp_path = tmp.name
        try:
            _write_file(tmp_path, arch, hparams, vocab, tensors, ftype,
                        progress)
            extra = {}
            if hparams.n_head_kv and hparams.n_head_kv != hparams.n_head:
                # classic llama hparams cannot carry GQA; GGUF can
                extra[f"{arch}.attention.head_count_kv"] = hparams.n_head_kv
            convert_ggml_to_gguf(tmp_path, output, architecture=arch,
                                 tokenizer_json=tokenizer_json,
                                 extra_metadata=extra)
        finally:
            os.unlink(tmp_path)
    else:
        _write_file(output, arch, hparams, vocab, tensors, ftype, progress)
    return arch


def _write_file(output, arch, hparams, vocab, tensors, ftype, progress):
    import re

    arch_info = get_arch(arch)
    quant_res = [re.compile(p) for p in arch_info.quantize_patterns]
    skip_res = [re.compile(p) for p in arch_info.skip_quantize_patterns]
    hparams.file_type = FileType(
        FileTypeFormat.MostlyF16 if ftype == "f16" else FileTypeFormat.F32, 0
    )
    hb = io.BytesIO()
    hparams.write_ggml(hb)
    with open(output, "wb") as f:
        w = GgmlWriter(f, ContainerType("ggjt", 3))
        w.write_header(hb.getvalue(), vocab)
        for name, arr in tensors:
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            # same per-tensor rule as the quantizer (quantize.rs:332-335)
            to_f16 = (
                ftype == "f16"
                and arr.ndim == 2
                and any(r.fullmatch(name) for r in quant_res)
                and not any(r.fullmatch(name) for r in skip_res)
            )
            dims = tuple(reversed(arr.shape))  # [R, K] row-major -> ggml (K, R)
            if to_f16:
                w.write_tensor(name, GgmlType.F16, dims,
                               arr.astype(np.float16).tobytes())
            else:
                w.write_tensor(name, GgmlType.F32, dims, arr.tobytes())
            if progress:
                progress(name)
