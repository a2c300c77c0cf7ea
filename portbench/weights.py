"""A cell's checkpoint, made from the seed on the card, and the port's model built from it.

The architecture's file (`archs/<arch>.py`) lists the tensors; each
block format's file (`formats/<fmt>.py`) draws random valid blocks of its
kind: random bytes with every scale field rewritten, the scales drawn
from the configuration's `weights` ranges, chosen so that a dequantized
weight has the spread of a trained 7B model's (std ~0.02); the repo's
test generator draws scales up to 50x larger, which makes attention
one-hot and the logits chaotic (ROADMAP C), so that no comparison could
tell bf16 rounding from a fault. f32 tensors are `weights["norm_std"]`
times normal noise, plus 1 for a vector not named `.bias` (a norm's
weight).

The bytes are made on the card with one `torch.Generator` in a few large
calls (every block format's blocks in one, in the order the formats first
appear in the tensor list, then every f32 tensor in one), copied to the
host once, and handed to the port's own load path
(`models.params.build_params` over a `WeightSource`) through a reader over
host memory with `GgmlReader`'s `tensors` / `fetch` interface: the H2D of
each tensor's raw bytes, `native.decode` and `pack_decoded` all run.
Nothing goes through a file.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import plugins


def hparams(cfg: dict) -> dict:
    """The harness's hyperparameters from the configuration's published
    keys, by its architecture's file."""
    return plugins.arch(cfg["arch"]).hparams(cfg)


def tensors_of(cfg: dict, hp: dict) -> list:
    """(name, ggml dims, format) of every tensor the architecture's file
    lists: the format it names, or else the configuration's block format
    for a matrix and f32 for a vector."""
    out = []
    for name, dims, *own in plugins.arch(hp["arch"]).tensor_list(hp):
        fmt = own[0] if own else cfg["format"] if len(dims) == 2 else "f32"
        out.append((name, tuple(dims), fmt))
    return out


@dataclass
class Checkpoint:
    """Raw tensors in host memory: name -> (format name, dims, uint8 array);
    the format is "f32" for the vectors and any tensor the architecture
    keeps in f32."""

    hp: dict
    tensors: dict


def make_checkpoint(cfg: dict, seed: int, device) -> Checkpoint:
    """Every tensor of the configuration from `seed`: one buffer of blocks
    for each block format and one of f32 values, each made on `device` and
    copied to the host once."""
    hp = hparams(cfg)
    entries = tensors_of(cfg, hp)
    w = cfg["weights"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    tensors = {}
    for fmt in dict.fromkeys(f for _, _, f in entries if f != "f32"):
        kind = plugins.fmt(fmt)
        mine = [(n, d) for n, d, f in entries if f == fmt]
        n_blocks = [math.prod(d) // kind.ELEMENTS for _, d in mine]
        raw = kind.draw(gen, sum(n_blocks), w, dev)
        raw_host = raw.reshape(-1).cpu().numpy()
        del raw
        off = 0
        for (name, dims), nb in zip(mine, n_blocks):
            tensors[name] = (fmt, dims, raw_host[off:off + nb * kind.BYTES])
            off += nb * kind.BYTES

    f32 = [(n, d) for n, d, f in entries if f == "f32"]
    sizes = [math.prod(d) for _, d in f32]
    v = torch.randn(sum(sizes), generator=gen, device=dev) * w["norm_std"]
    v_host = v.cpu().numpy().astype(np.float32)
    del v
    off = 0
    for (name, dims), n in zip(f32, sizes):
        x = v_host[off:off + n]
        if len(dims) == 1 and not name.endswith(".bias"):
            x += 1.0  # a norm's weight: 1 plus noise; a bias: noise
        tensors[name] = ("f32", dims, x.view(np.uint8))
        off += n
    return Checkpoint(hp, tensors)


def ggml_type(fmt: str):
    """The port's `GgmlType` of a format name: f32, or a format file's."""
    from llm_tpu_torch.ggml.types import GgmlType

    return GgmlType.F32 if fmt == "f32" else \
        GgmlType[plugins.fmt(fmt).GGML_TYPE]


class MemoryReader:
    """`GgmlReader`'s `tensors` / `fetch` over a Checkpoint in host memory."""

    def __init__(self, ckpt: Checkpoint):
        from llm_tpu_torch.ggml.reader import TensorInfo

        self._data = {}
        self.tensors = {}
        for name, (fmt, dims, arr) in ckpt.tensors.items():
            self.tensors[name] = TensorInfo(name, len(dims), tuple(dims),
                                            ggml_type(fmt), 0)
            self._data[name] = arr

    def fetch(self, name: str) -> np.ndarray:
        return self._data[name]


def build_model(cfg: dict, ckpt: Checkpoint, device):
    """The port's `loader.Model` over the checkpoint, built by the port's
    own path; returns (model, seconds of building the weights, ending in a
    synchronize)."""
    from llm_tpu_torch.ggml.types import (ELEMENT_TYPE_TO_FILE_TYPE,
                                          QNT_VERSION, ContainerType,
                                          FileType)
    from llm_tpu_torch.loader import Model, ModelParameters
    from llm_tpu_torch.models.params import WeightSource, build_params
    from llm_tpu_torch.models.spec import (Hyperparameters, get_arch,
                                           with_runtime_params)
    from llm_tpu_torch.tokenizer import Tokenizer
    from llm_tpu_torch.tokenizer.embedded import EmbeddedTokenizer

    hp = ckpt.hp
    mine = plugins.arch(hp["arch"])
    h = Hyperparameters(arch=mine.PORT_ARCH, **mine.port_hparams(hp))
    h.file_type = FileType(
        format=ELEMENT_TYPE_TO_FILE_TYPE[ggml_type(cfg["format"])],
        quantization_version=QNT_VERSION)
    arch = get_arch(mine.PORT_ARCH)
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
