"""Falcon (tiiuae `modelling_RW`): the harness's hyperparameters from the
configuration's published keys, the tensors of a checkpoint in the names
the port's builders read (as `llm_tpu_torch.testing._tensor_names`), the
port's hyperparameters, and the widths the roofline counts."""

from __future__ import annotations

from portbench import plugins
from portbench.roofline import Shape

PORT_ARCH = "falcon"  # the port's `models.spec.get_arch` name


def hparams(cfg: dict) -> dict:
    e = cfg["hidden_size"]
    return dict(arch=cfg["arch"], n_embd=e, n_head=cfg["num_attention_heads"],
                n_head_kv=1 if cfg["multi_query"] else
                cfg["num_attention_heads"],
                n_layer=cfg["num_hidden_layers"],
                n_vocab=cfg["vocab_size"], n_ff=cfg["ffn_hidden_size"])


def tensor_list(hp: dict) -> list:
    """(name, ggml dims (K, R) or (E,)) of every tensor: each matrix in the
    configuration's block format, each vector f32."""
    E, V, L, F = hp["n_embd"], hp["n_vocab"], hp["n_layer"], hp["n_ff"]
    hd = E // hp["n_head"]
    fused = hd * (hp["n_head"] + 2 * hp["n_head_kv"])
    out = [("transformer.word_embeddings.weight", (E, V)),
           ("transformer.ln_f.weight", (E,)),
           ("transformer.ln_f.bias", (E,)),
           ("lm_head.weight", (E, V))]
    for i in range(L):
        p = f"transformer.h.{i}"
        out += [(f"{p}.input_layernorm.weight", (E,)),
                (f"{p}.input_layernorm.bias", (E,)),
                (f"{p}.self_attention.query_key_value.weight", (E, fused)),
                (f"{p}.self_attention.dense.weight", (E, E)),
                (f"{p}.mlp.dense_h_to_4h.weight", (E, F)),
                (f"{p}.mlp.dense_4h_to_h.weight", (F, E))]
    return out


def port_hparams(hp: dict) -> dict:
    """The fields of the port's `Hyperparameters` a Falcon file sets."""
    return {k: hp[k] for k in ("n_embd", "n_head", "n_head_kv", "n_layer",
                               "n_vocab")}


def shape_of(cfg: dict, hp: dict) -> Shape:
    """A dense Shape: the fused q|k|v, wo, up and down of every layer."""
    E, F = hp["n_embd"], hp["n_ff"]
    hd = E // hp["n_head"]
    qkv = hd * (hp["n_head"] + 2 * hp["n_head_kv"])
    mats = [(E, qkv), (E, E), (E, F), (F, E)]
    kv = cfg["kv_bytes"]
    return Shape(hp["n_layer"], E, hp["n_head"], hp["n_head_kv"],
                 hp["n_vocab"], mats, plugins.fmt(cfg["format"]).BITS,
                 kv["element"], kv["scale"])
