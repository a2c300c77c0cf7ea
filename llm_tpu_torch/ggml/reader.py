"""GGML container reader — index-building parser.

Parses the GGML / GGMF / GGJT / GGLA container family exactly as the
reference's format loader does (llm/crates/ggml/src/format/loader.rs):

    magic [+version]
    hyperparameters        (model-specific; caller supplies a codec)
    vocabulary             n_vocab x {u32 len; bytes; f32 score if scored}
    tensors                {i32 n_dims; i32 name_len; u32 ftype; i32 dims[n];
                            name; [align 32B if ggjt/ggla]; data}

Where the reference is callback-driven (LoadHandler), this implementation is
TPU-idiomatic host code: one pass builds an index of TensorInfo, and tensor
data is then fetched lazily by name via numpy memmap (zero-copy for aligned
containers) — the analog of MmapCompatibleLoader
(llm/crates/llm-base/src/loader.rs:641-756).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Callable, Optional

import numpy as np

from llm_tpu_torch.ggml.types import ContainerType, GgmlType, data_size


class FormatError(ValueError):
    """Invalid or unsupported container contents."""


@dataclass
class TensorInfo:
    """Mirror of TensorLoadInfo (format/loader.rs:73-119)."""

    name: str
    n_dims: int
    dims: tuple[int, ...]  # ggml order: dims[0] = row length (contiguous axis)
    element_type: GgmlType
    start_offset: int

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def calc_size(self) -> int:
        return data_size(self.element_type, self.n_elements)


@dataclass
class Vocabulary:
    tokens: list[bytes] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.tokens)


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise FormatError("unexpected end of file")
    return b


def _read_u32(f: BinaryIO) -> int:
    return struct.unpack("<I", _read_exact(f, 4))[0]


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", _read_exact(f, 4))[0]


def _read_f32(f: BinaryIO) -> float:
    return struct.unpack("<f", _read_exact(f, 4))[0]


class GgmlReader:
    """Parses a GGML-family file into {container, hparams, vocab, tensor index}.

    `read_hyperparameters(f) -> (hparams, n_vocab)` is the per-architecture
    codec (the analog of Hyperparameters::read_ggml). For GGLA (LoRA) files
    n_vocab is 0, so the vocab section is skipped.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.container: Optional[ContainerType] = None
        self.vocabulary = Vocabulary()
        self.tensors: dict[str, TensorInfo] = {}
        self.hyperparameters = None
        self._mmap: Optional[np.ndarray] = None

    def load(
        self, read_hyperparameters: Callable[[BinaryIO], tuple[object, int]]
    ) -> "GgmlReader":
        with open(self.path, "rb") as f:
            container = ContainerType.read(f)
            if not container.is_supported():
                raise FormatError(f"invalid ggml format: format={container!r}")
            self.container = container

            self.hyperparameters, n_vocab = read_hyperparameters(f)

            for _ in range(n_vocab):
                ln = _read_u32(f)
                token = f.read(ln)
                if len(token) != ln:
                    raise FormatError("unexpected EOF in vocabulary")
                score = _read_f32(f) if container.has_scored_vocab else 0.0
                self.vocabulary.tokens.append(token)
                self.vocabulary.scores.append(score)

            tensor_section_start = f.tell()
            self._read_tensor_index(f, tensor_section_start, container.aligned_tensors)
        return self

    def _read_tensor_index(self, f: BinaryIO, start: int, align: bool) -> None:
        """Walk tensor headers, 32-byte-aligning data offsets for mmap formats
        and skipping past the data (format/loader.rs:214-281)."""
        f.seek(0, 2)
        file_len = f.tell()
        pos = start
        while pos < file_len:
            f.seek(pos)
            n_dims = _read_i32(f)
            name_len = _read_i32(f)
            ftype_raw = _read_u32(f)
            if n_dims > 2 or n_dims < 0:
                raise FormatError(f"invariant broken: {n_dims} <= 2")
            if name_len < 0:
                raise FormatError(f"invariant broken: name_len {name_len}")
            dims = []
            for _ in range(n_dims):
                d = _read_i32(f)
                if d <= 0:
                    # a negative dim gives a NEGATIVE calc_size and walks
                    # `pos` backwards (untyped OSError on the next seek)
                    raise FormatError(f"invariant broken: dim {d} <= 0")
                dims.append(d)
            name_b = f.read(name_len)
            if len(name_b) != name_len:
                raise FormatError("unexpected end of file in tensor name")
            name = name_b.decode("utf-8", errors="replace")
            try:
                element_type = GgmlType(ftype_raw)
            except ValueError:
                raise FormatError(
                    f"unsupported tensor type {ftype_raw} for tensor {name}"
                ) from None
            # sanity check (format/loader.rs:248-255)
            if element_type in (GgmlType.Q4_0, GgmlType.Q4_1) and dims and dims[0] % 64 != 0:
                raise FormatError(f"invariant broken: {dims}[0] % 64 == 0")

            offset_curr = f.tell()
            offset_aligned = (offset_curr + 31) & ~31 if align else offset_curr

            info = TensorInfo(
                name=name,
                n_dims=n_dims,
                dims=tuple(dims) if dims else (1,),
                element_type=element_type,
                start_offset=offset_aligned,
            )
            self.tensors[name] = info
            pos = offset_aligned + info.calc_size()
        if pos != file_len:
            raise FormatError("tensor data overruns end of file")

    def fetch(self, name: str) -> np.ndarray:
        """Raw bytes of a tensor as uint8 (zero-copy memmap)."""
        info = self.tensors[name]
        if self._mmap is None:
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
        return self._mmap[info.start_offset : info.start_offset + info.calc_size()]

    def fetch_f32(self, name: str) -> np.ndarray:
        """Tensor dequantized to float32, shaped [dims[-1], ..., dims[0]].

        ggml dims are (row_len, n_rows, ...) with dims[0] contiguous; numpy
        row-major means the returned shape is reversed ggml dims.
        """
        info = self.tensors[name]
        from llm_tpu_torch.ggml.quant import dequantize

        flat = dequantize(info.element_type, self.fetch(name), info.n_elements)
        return flat.reshape(tuple(reversed(info.dims)))
