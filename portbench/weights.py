"""A cell's checkpoint, made from the seed on the card, and the port's model built from it.

The block bytes are random valid GGML blocks, as `llm_tpu_torch.testing`'s
`_random_scalar_quant` makes them (copied here, not imported): random
bytes with every f16 scale field rewritten. The scales
are drawn from the configuration's `weights` ranges, chosen so that a
dequantized weight has the spread of a trained 7B model's (std ~0.02); the
repo's test generator draws scales up to 50x larger, which makes attention
one-hot and the logits chaotic (ROADMAP C), so that no comparison could
tell bf16 rounding from a fault.

The bytes are made on the card with one `torch.Generator` in a few large
calls, copied to the host once, and handed to the port's own load path
(`models.params.build_params` over a `WeightSource`) through a reader over
host memory with `GgmlReader`'s `tensors` / `fetch` interface: the H2D of
each tensor's raw bytes, `native.decode` and `pack_decoded` all run.
Nothing goes through a file.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

# elements a block, bytes a block, byte offset of the f16 scale field d
FORMATS = {
    "q4_0": (32, 18, 0),
}


def hparams(cfg: dict) -> dict:
    """The port's hyperparameters from the configuration's published keys."""
    arch = cfg["arch"]
    if arch == "falcon":
        e = cfg["hidden_size"]
        return dict(arch=arch, n_embd=e, n_head=cfg["num_attention_heads"],
                    n_head_kv=1 if cfg["multi_query"] else
                    cfg["num_attention_heads"],
                    n_layer=cfg["num_hidden_layers"],
                    n_vocab=cfg["vocab_size"], n_ff=cfg["ffn_hidden_size"])
    raise ValueError(f"no architecture {arch!r}")


def tensor_list(hp: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, ggml dims (K, R) or (E,)) of every tensor, in the names the
    port's builders read (as `llm_tpu_torch.testing._tensor_names`)."""
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


@dataclass
class Checkpoint:
    """Raw tensors in host memory: name -> (format name, dims, uint8 array);
    the format is "f32" for the 1-D norms and biases."""

    hp: dict
    tensors: dict


def _scale_bits(gen, n: int, lo: float, hi: float, dev) -> torch.Tensor:
    d = torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo
    return d.to(torch.float16).view(torch.uint8).view(n, 2)


def make_checkpoint(cfg: dict, seed: int, device) -> Checkpoint:
    """Every tensor of the configuration from `seed`: one buffer of block
    bytes and one of f32 vectors, each made on `device` and copied to the
    host once."""
    hp = hparams(cfg)
    fmt = cfg["format"]
    bs, ts, d_at = FORMATS[fmt]
    w = cfg["weights"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    names = tensor_list(hp)
    mats = [(n, d) for n, d in names if len(d) == 2]
    vecs = [(n, d) for n, d in names if len(d) == 1]

    n_blocks = [d[0] * d[1] // bs for _, d in mats]
    total = sum(n_blocks)
    raw = torch.randint(0, 256, (total, ts), dtype=torch.uint8,
                        generator=gen, device=dev)
    d_bits = _scale_bits(gen, total, *w["d"], dev)
    raw[:, d_at:d_at + 2] = d_bits
    raw_host = raw.reshape(-1).cpu().numpy()
    del raw, d_bits

    sizes = [d[0] for _, d in vecs]
    v = torch.randn(sum(sizes), generator=gen, device=dev) * w["norm_std"]
    v_host = v.cpu().numpy().astype(np.float32)
    del v

    tensors = {}
    off = 0
    for (name, dims), nb in zip(mats, n_blocks):
        tensors[name] = (fmt, dims, raw_host[off:off + nb * ts])
        off += nb * ts
    off = 0
    for name, dims in vecs:
        x = v_host[off:off + dims[0]]
        if not name.endswith(".bias"):
            x += 1.0  # a norm's weight: 1 plus noise; a bias: noise
        tensors[name] = ("f32", dims, x.view(np.uint8))
        off += dims[0]
    return Checkpoint(hp, tensors)


class MemoryReader:
    """`GgmlReader`'s `tensors` / `fetch` over a Checkpoint in host memory."""

    def __init__(self, ckpt: Checkpoint):
        from llm_tpu_torch.ggml.reader import TensorInfo
        from llm_tpu_torch.ggml.types import GgmlType

        types = {"q4_0": GgmlType.Q4_0, "f32": GgmlType.F32}
        self._data = {}
        self.tensors = {}
        for name, (fmt, dims, arr) in ckpt.tensors.items():
            self.tensors[name] = TensorInfo(name, len(dims), tuple(dims),
                                            types[fmt], 0)
            self._data[name] = arr

    def fetch(self, name: str) -> np.ndarray:
        return self._data[name]


def build_model(cfg: dict, ckpt: Checkpoint, device):
    """The port's `loader.Model` over the checkpoint, built by the port's
    own path; returns (model, seconds of building the weights, ending in a
    synchronize)."""
    from llm_tpu_torch.ggml.types import (ELEMENT_TYPE_TO_FILE_TYPE,
                                          QNT_VERSION, ContainerType,
                                          FileType, GgmlType)
    from llm_tpu_torch.loader import Model, ModelParameters
    from llm_tpu_torch.models.params import WeightSource, build_params
    from llm_tpu_torch.models.spec import (Hyperparameters, get_arch,
                                           with_runtime_params)
    from llm_tpu_torch.tokenizer import Tokenizer
    from llm_tpu_torch.tokenizer.embedded import EmbeddedTokenizer

    hp = ckpt.hp
    h = Hyperparameters(arch=hp["arch"])
    for k in ("n_embd", "n_head", "n_head_kv", "n_layer", "n_vocab"):
        setattr(h, k, hp[k])
    et = {"q4_0": GgmlType.Q4_0}[cfg["format"]]
    h.file_type = FileType(format=ELEMENT_TYPE_TO_FILE_TYPE[et],
                           quantization_version=QNT_VERSION)
    arch = get_arch(hp["arch"])
    spec = with_runtime_params(arch.make_spec(h),
                               context_size=cfg["context"])
    emb = EmbeddedTokenizer()
    for i, tok in enumerate(vocabulary(hp["n_vocab"])):
        emb.push_token(i, tok, 0.0)
    dev = torch.device(device)
    t0 = time.monotonic()
    params = build_params(WeightSource(MemoryReader(ckpt), dev), spec)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    load_s = time.monotonic() - t0
    model = Model(arch, h, spec, params, Tokenizer(emb),
                  ModelParameters(context_size=cfg["context"]),
                  ContainerType("ggjt", 3), dev)
    return model, load_s


EOT_ID = 0  # the vocabulary's <|endoftext|>


def vocabulary(n: int) -> list[bytes]:
    """Token 0 is the end of text the architectures name; the rest are
    distinct placeholders (ids are drawn, never text)."""
    return [b"<|endoftext|>"] + [f"<t{i}>".encode() for i in range(1, n)]
