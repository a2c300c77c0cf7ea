"""Test-support: synthesize tiny random GGML checkpoints for every arch.

The reference integration harness (binaries/llm-test) downloads small real
models from HF; with zero egress we instead generate tiny random checkpoints
through our own writer, which exercises the same loader/graph/session paths.
Golden-output determinism comes from the greedy DeterministicSampler analog
(llm-test/src/inference.rs:94-117), not from fixed weights.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

from llm_tpu_torch.ggml.quant import quantize
from llm_tpu_torch.ggml.types import (
    ELEMENT_TYPE_TO_FILE_TYPE,
    QNT_VERSION,
    ContainerType,
    FileType,
    GgmlType,
)
from llm_tpu_torch.ggml.writer import GgmlWriter
from llm_tpu_torch.models.spec import Hyperparameters


def tiny_hparams(arch: str, **overrides) -> Hyperparameters:
    h = Hyperparameters(arch=arch)
    h.n_vocab = 96
    h.n_embd = 64
    h.n_head = 4
    h.n_head_kv = 4
    h.n_layer = 2
    h.n_ctx = 64
    h.n_mult = 32
    h.n_rot = 16  # = head_dim
    h.max_seq_len = 64
    h.alibi_bias_max = 8.0
    h.use_parallel_residual = True
    if arch == "falcon":
        h.n_head_kv = 1
    for k, v in overrides.items():
        setattr(h, k, v)
    # derived defaults must not clobber EXPLICIT overrides (a test asking
    # for GQA via n_head_kv=2 or a custom n_rot would silently get the
    # default geometry back)
    if arch not in ("falcon",) and "n_head_kv" not in overrides:
        h.n_head_kv = h.n_head
    if "n_rot" not in overrides:
        h.n_rot = h.n_embd // h.n_head
    return h


def _tensor_names(
    arch: str, h: Hyperparameters, n_ff: int | None = None
) -> list[tuple[str, tuple[int, ...]]]:
    """(name, ggml dims (K, R)) for every tensor of a tiny model."""
    E, V, L = h.n_embd, h.n_vocab, h.n_layer
    # tiny FFN default; real models derive n_ff from tensor shapes anyway
    F = n_ff if n_ff is not None else 2 * E
    hd = E // h.n_head
    out = []

    if arch == "llama":
        out += [("tok_embeddings.weight", (E, V)), ("norm.weight", (E,)),
                ("output.weight", (E, V))]
        for i in range(L):
            p = f"layers.{i}"
            out += [
                (f"{p}.attention_norm.weight", (E,)),
                (f"{p}.attention.wq.weight", (E, E)),
                (f"{p}.attention.wk.weight", (E, E)),
                (f"{p}.attention.wv.weight", (E, E)),
                (f"{p}.attention.wo.weight", (E, E)),
                (f"{p}.ffn_norm.weight", (E,)),
                (f"{p}.feed_forward.w1.weight", (E, F)),
                (f"{p}.feed_forward.w2.weight", (F, E)),
                (f"{p}.feed_forward.w3.weight", (E, F)),
            ]
    elif arch == "gpt2":
        out += [("model/wte", (E, V)), ("model/wpe", (E, h.n_ctx)),
                ("model/ln_f/g", (E,)), ("model/ln_f/b", (E,))]
        for i in range(L):
            p = f"model/h{i}"
            out += [
                (f"{p}/ln_1/g", (E,)), (f"{p}/ln_1/b", (E,)),
                (f"{p}/ln_2/g", (E,)), (f"{p}/ln_2/b", (E,)),
                (f"{p}/attn/c_attn/w", (E, 3 * E)), (f"{p}/attn/c_attn/b", (3 * E,)),
                (f"{p}/attn/c_proj/w", (E, E)), (f"{p}/attn/c_proj/b", (E,)),
                (f"{p}/mlp/c_fc/w", (E, F)), (f"{p}/mlp/c_fc/b", (F,)),
                (f"{p}/mlp/c_proj/w", (F, E)), (f"{p}/mlp/c_proj/b", (E,)),
            ]
    elif arch == "gptj":
        out += [("transformer.wte.weight", (E, V)),
                ("transformer.ln_f.weight", (E,)), ("transformer.ln_f.bias", (E,)),
                ("lm_head.weight", (E, V)), ("lm_head.bias", (V,))]
        for i in range(L):
            p = f"transformer.h.{i}"
            out += [
                (f"{p}.ln_1.weight", (E,)), (f"{p}.ln_1.bias", (E,)),
                (f"{p}.attn.q_proj.weight", (E, E)),
                (f"{p}.attn.k_proj.weight", (E, E)),
                (f"{p}.attn.v_proj.weight", (E, E)),
                (f"{p}.attn.out_proj.weight", (E, E)),
                (f"{p}.mlp.fc_in.weight", (E, F)), (f"{p}.mlp.fc_in.bias", (F,)),
                (f"{p}.mlp.fc_out.weight", (F, E)), (f"{p}.mlp.fc_out.bias", (E,)),
            ]
    elif arch == "gptneox":
        out += [("gpt_neox.embed_in.weight", (E, V)),
                ("gpt_neox.final_layer_norm.weight", (E,)),
                ("gpt_neox.final_layer_norm.bias", (E,)),
                ("embed_out.weight", (E, V))]
        for i in range(L):
            p = f"gpt_neox.layers.{i}"
            out += [
                (f"{p}.input_layernorm.weight", (E,)),
                (f"{p}.input_layernorm.bias", (E,)),
                (f"{p}.post_attention_layernorm.weight", (E,)),
                (f"{p}.post_attention_layernorm.bias", (E,)),
                (f"{p}.attention.query_key_value.weight", (E, 3 * E)),
                (f"{p}.attention.query_key_value.bias", (3 * E,)),
                (f"{p}.attention.dense.weight", (E, E)),
                (f"{p}.attention.dense.bias", (E,)),
                (f"{p}.mlp.dense_h_to_4h.weight", (E, F)),
                (f"{p}.mlp.dense_h_to_4h.bias", (F,)),
                (f"{p}.mlp.dense_4h_to_h.weight", (F, E)),
                (f"{p}.mlp.dense_4h_to_h.bias", (E,)),
            ]
    elif arch == "bloom":
        out += [("tok_embeddings.weight", (E, V)),
                ("norm.weight", (E,)), ("norm.bias", (E,)),
                ("output_norm.weight", (E,)), ("output_norm.bias", (E,)),
                ("output.weight", (E, V))]
        for i in range(L):
            p = f"layers.{i}"
            out += [
                (f"{p}.attention_norm.weight", (E,)), (f"{p}.attention_norm.bias", (E,)),
                (f"{p}.attention.query_key_value.weight", (E, 3 * E)),
                (f"{p}.attention.query_key_value.bias", (3 * E,)),
                (f"{p}.attention.wo.weight", (E, E)), (f"{p}.attention.wo.bias", (E,)),
                (f"{p}.ffn_norm.weight", (E,)), (f"{p}.ffn_norm.bias", (E,)),
                (f"{p}.feed_forward.w1.weight", (E, F)),
                (f"{p}.feed_forward.w1.bias", (F,)),
                (f"{p}.feed_forward.w2.weight", (F, E)),
                (f"{p}.feed_forward.w2.bias", (E,)),
            ]
    elif arch == "mpt":
        out += [("transformer.wte.weight", (E, V)),
                ("transformer.norm_f.weight", (E,))]
        for i in range(L):
            p = f"transformer.blocks.{i}"
            out += [
                (f"{p}.norm_1.weight", (E,)),
                (f"{p}.attn.Wqkv.weight", (E, 3 * E)),
                (f"{p}.attn.out_proj.weight", (E, E)),
                (f"{p}.norm_2.weight", (E,)),
                (f"{p}.ffn.up_proj.weight", (E, F)),
                (f"{p}.ffn.down_proj.weight", (F, E)),
            ]
    elif arch == "falcon":
        kv = h.n_head_kv
        fused = hd * (h.n_head + 2 * kv)
        out += [("transformer.word_embeddings.weight", (E, V)),
                ("transformer.ln_f.weight", (E,)), ("transformer.ln_f.bias", (E,)),
                ("lm_head.weight", (E, V))]
        for i in range(L):
            p = f"transformer.h.{i}"
            if kv == 1:  # falcon 7B: one shared LN
                out += [(f"{p}.input_layernorm.weight", (E,)),
                        (f"{p}.input_layernorm.bias", (E,))]
            else:  # falcon 40B: ln_attn + ln_mlp (falcon/src/lib.rs:72-97)
                out += [(f"{p}.ln_attn.weight", (E,)), (f"{p}.ln_attn.bias", (E,)),
                        (f"{p}.ln_mlp.weight", (E,)), (f"{p}.ln_mlp.bias", (E,))]
            out += [
                (f"{p}.self_attention.query_key_value.weight", (E, fused)),
                (f"{p}.self_attention.dense.weight", (E, E)),
                (f"{p}.mlp.dense_h_to_4h.weight", (E, F)),
                (f"{p}.mlp.dense_4h_to_h.weight", (F, E)),
            ]
    else:
        raise ValueError(arch)
    return out


# byte offsets of each format's f16 fields (d, and dmin or m)
_F16_FIELDS = {
    GgmlType.Q4_0: [0], GgmlType.Q4_1: [0, 2], GgmlType.Q5_0: [0],
    GgmlType.Q5_1: [0, 2], GgmlType.Q8_0: [0], GgmlType.Q2_K: [80, 82],
    GgmlType.Q3_K: [108], GgmlType.Q4_K: [0, 2], GgmlType.Q5_K: [0, 2],
    GgmlType.Q6_K: [208],
}


def _random_kquant(rng, t: GgmlType, n: int) -> bytes:
    """Random valid K-quant block bytes (we read K-quants but, like the
    reference, never write them from floats — quantize.rs:224-244)."""
    from llm_tpu_torch.ggml.types import block_size, type_size

    nb = n // block_size(t)
    raw = rng.integers(0, 256, size=(nb, type_size(t)), dtype=np.uint8)
    d16 = (
        np.float16(rng.uniform(0.001, 0.05, size=nb)).view(np.uint8).reshape(nb, 2)
    )
    for o in _F16_FIELDS[t]:
        raw[:, o : o + 2] = d16
    return raw.tobytes()


_K_QUANTS = {GgmlType.Q2_K, GgmlType.Q3_K, GgmlType.Q4_K, GgmlType.Q5_K,
             GgmlType.Q6_K}

# the K-quants' packed sub-block scale bytes
_SCALE_BYTES = {GgmlType.Q2_K: (0, 16), GgmlType.Q3_K: (96, 108),
                GgmlType.Q4_K: (4, 16), GgmlType.Q5_K: (4, 16),
                GgmlType.Q6_K: (192, 208)}
# f16 bit patterns of the edge blocks' d fields: zero, -0.0, a negative
# normal, the smallest and a mid subnormal, a negative subnormal
EDGE_F16 = (0x0000, 0x8000, 0xA24E, 0x0001, 0x0203, 0x83FF)


def codec_blocks(t: GgmlType, K: int, R: int, rng, edges: bool = False):
    """Raw block bytes (uint8 numpy, R * K / bs blocks) of a [K, R] tensor
    of type `t` for the codec checks: random bytes with finite f16 fields.
    `edges` rewrites the first blocks: one block for each d of EDGE_F16
    (dmin or m alike), then for a K-quant a block with every packed scale
    byte 0xFF (6-bit scales and mins all 63; Q2_K's 15; Q3_K's 63 - 32;
    Q6_K's -1) and a block with every scale byte 0x80 (Q6_K's -128) and
    one with 0x7F (Q6_K's 127)."""
    from llm_tpu_torch.ggml.types import block_size, type_size

    nb = K * R // block_size(t)
    raw = np.frombuffer(
        _random_kquant(rng, t, K * R) if t in _K_QUANTS
        else _random_scalar_quant(rng, t, K * R), np.uint8
    ).reshape(nb, type_size(t)).copy()
    if not edges:
        return raw.reshape(-1)
    special = [np.array([h], np.uint16).view(np.uint8) for h in EDGE_F16]
    for i, h in enumerate(special):
        for o in _F16_FIELDS[t]:
            raw[i, o:o + 2] = h
    if t in _SCALE_BYTES:
        a, b = _SCALE_BYTES[t]
        for i, v in enumerate((0xFF, 0x80, 0x7F)):
            raw[len(special) + i, a:b] = v
    return raw.reshape(-1)


def make_tiny_file(
    arch: str,
    path: str | Path,
    element_type: GgmlType = GgmlType.F32,
    seed: int = 0,
    n_ff: int | None = None,
    **hparam_overrides,
) -> Hyperparameters:
    """Write a tiny random checkpoint; 2-D tensors use `element_type`.
    `n_ff` sets the feed-forward width (default 2 * n_embd).

    K-quant element types need n_embd a multiple of 256 (QK_K), e.g.
    make_tiny_file("llama", p, GgmlType.Q4_K, n_embd=256).
    """
    rng = np.random.default_rng(seed)
    h = tiny_hparams(arch, **hparam_overrides)
    h.file_type = FileType(
        format=ELEMENT_TYPE_TO_FILE_TYPE[element_type],
        quantization_version=QNT_VERSION if element_type.is_quantized else 0,
    )

    hb = io.BytesIO()
    h.write_ggml(hb)

    # token 0 is the architecture's EOT string so eot_token_id() resolves
    eot = b"</s>" if arch in ("llama", "bloom") else b"<|endoftext|>"
    vocab = []
    for i in range(h.n_vocab):
        tok = eot if i == 0 else f"<t{i}>".encode()
        vocab.append((tok, float(len(tok) * len(tok))))

    with open(path, "wb") as f:
        w = GgmlWriter(f, ContainerType("ggjt", 3))
        w.write_header(hb.getvalue(), vocab)
        for name, dims in _tensor_names(arch, h, n_ff=n_ff):
            n = int(np.prod(dims))
            data = (rng.standard_normal(n, dtype=np.float32) * 0.1).astype(np.float32)
            if len(dims) == 2 and element_type != GgmlType.F32:
                if element_type == GgmlType.F16:
                    w.write_tensor(name, element_type, dims, data.astype(np.float16).tobytes())
                elif element_type in _K_QUANTS:
                    w.write_tensor(name, element_type, dims,
                                   _random_kquant(rng, element_type, n))
                else:
                    w.write_tensor(name, element_type, dims, quantize(element_type, data))
            else:
                w.write_tensor(name, GgmlType.F32, dims, data.tobytes())
    return h


def _random_scalar_quant(rng, t: GgmlType, n: int) -> bytes:
    """Random VALID scalar-quant block bytes at GB scale: raw random bits
    with the f16 scale (and min) fields rewritten to small normal values so
    dequantized weights stay sane. ~10x faster than quantizing floats —
    what the full-geometry bench checkpoints use."""
    from llm_tpu_torch.ggml.types import block_size, type_size

    nb = n // block_size(t)
    ts = type_size(t)
    # GB-scale: tile one 16 MB random pool instead of drawing every byte
    # (weight content is irrelevant to the bench; only the layout and the
    # scale magnitudes matter)
    pool = np.frombuffer(rng.bytes(1 << 24), dtype=np.uint8)
    raw = np.resize(pool, (nb, ts)).copy()
    d16 = (
        np.float16(
            np.resize(
                np.frombuffer(rng.bytes(1 << 20), np.uint16).astype(np.float32)
                / 65535.0 * 0.019 + 0.001,
                nb,
            )
        )
        .view(np.uint8)
        .reshape(nb, 2)
    )
    for o in _F16_FIELDS[t]:
        raw[:, o : o + 2] = d16
    return raw.tobytes()


def make_bench_file(
    arch: str,
    path: str | Path,
    element_type: GgmlType,
    seed: int = 0,
    n_ff: int | None = None,
    **hparam_overrides,
) -> Hyperparameters:
    """Write a FULL-GEOMETRY random checkpoint (e.g. LLaMA-7B Q4_0,
    ~3.9 GB) fast: quant tensors get random valid block bytes instead of
    quantized floats. Exercises the complete load path — container parse,
    32000-entry vocab, native transcode of GB-scale planes, host->HBM
    transfer — at real scale (loader.rs:419-567 analog)."""
    rng = np.random.default_rng(seed)
    h = tiny_hparams(arch, **hparam_overrides)
    h.file_type = FileType(
        format=ELEMENT_TYPE_TO_FILE_TYPE[element_type],
        quantization_version=QNT_VERSION if element_type.is_quantized else 0,
    )
    eot = b"</s>" if arch in ("llama", "bloom") else b"<|endoftext|>"
    vocab = [
        (eot if i == 0 else f"<t{i}>".encode(), float(i % 97))
        for i in range(h.n_vocab)
    ]
    hb = io.BytesIO()
    h.write_ggml(hb)
    with open(path, "wb") as f:
        w = GgmlWriter(f, ContainerType("ggjt", 3))
        w.write_header(hb.getvalue(), vocab)
        for name, dims in _tensor_names(arch, h, n_ff=n_ff):
            n = int(np.prod(dims))
            if len(dims) == 2:
                if element_type in _K_QUANTS:
                    data = _random_kquant(rng, element_type, n)
                else:
                    data = _random_scalar_quant(rng, element_type, n)
                w.write_tensor(name, element_type, dims, data)
            else:
                data = (rng.standard_normal(n, dtype=np.float32) * 0.05 + 1.0)
                w.write_tensor(name, GgmlType.F32, dims,
                               data.astype(np.float32).tobytes())
    return h


def make_lora_file(
    path: str | Path,
    names,
    shapes: dict,
    r: int,
    alpha: int,
    seed: int = 0,
    scale: float = 0.1,
) -> dict:
    """Write a random GGLA adapter (magic 'ggla' v1, hyperparameters
    {r, alpha}, no vocabulary, 32-byte aligned f32 tensors) patching each
    weight of `names`, whose ggml dims (K, R) `shapes` gives: A as numpy
    [K, r] (`{name}.loraA`) and B as [R, r] (`{name}.loraB`), normal with
    standard deviation `scale`. Returns {name: (A, B)}."""
    import struct

    rng = np.random.default_rng(seed)
    factors = {}
    with open(path, "wb") as f:
        ContainerType("ggla", 1).write(f)
        f.write(struct.pack("<ii", r, alpha))
        for name in names:
            K, R = shapes[name]
            a = (rng.standard_normal((K, r), dtype=np.float32) * scale)
            b = (rng.standard_normal((R, r), dtype=np.float32) * scale)
            factors[name] = (a, b)
            for suffix, arr in ((".loraA", a), (".loraB", b)):
                dims = tuple(reversed(arr.shape))  # numpy [R, K] -> (K, R)
                nb = (name + suffix).encode()
                f.write(struct.pack("<iiI", len(dims), len(nb),
                                    int(GgmlType.F32)))
                for d in dims:
                    f.write(struct.pack("<i", d))
                f.write(nb)
                f.write(b"\x00" * ((-f.tell()) % 32))
                f.write(np.ascontiguousarray(arr).tobytes())
    return factors
