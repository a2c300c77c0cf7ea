"""GGML type metadata: element types, container magics, file-level ftypes.

Mirrors the type tables of the reference:
- element type ids:     llm/crates/ggml/sys/src/lib.rs:51-68
- block/type sizes:     ggml.c GGML_BLCK_SIZE / GGML_TYPE_SIZE tables
- container magics:     llm/crates/ggml/src/lib.rs:112-118
- llama_ftype values:   llm/crates/ggml/sys/src/llama.rs:16-32
- FileType encoding:    llm/crates/llm-base/src/loader.rs:24-56
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

QNT_VERSION = 2  # sys/src/lib.rs:18
QNT_VERSION_FACTOR = 1000  # sys/src/lib.rs:19
QK_K = 256  # K-quant super-block size, sys/src/lib.rs:31
MAX_NAME_LENGTH = 48  # GGML_MAX_NAME, sys/src/lib.rs:25

FILE_MAGIC_GGML = 0x67676D6C
FILE_MAGIC_GGMF = 0x67676D66
FILE_MAGIC_GGJT = 0x67676A74
FILE_MAGIC_GGLA = 0x67676C61

DEFAULT_RMS_EPS = 5e-6  # LLAMA_DEFAULT_RMS_EPS, sys/src/llama.rs:15


class GgmlType(enum.IntEnum):
    """ggml_type — on-disk element types (sys/src/lib.rs:51-68)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3, removed upstream
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18

    @property
    def is_quantized(self) -> bool:
        return self in _QUANTIZED

    def __str__(self) -> str:  # "q4_0" style, matches Display impl
        return self.name.lower()


_QUANTIZED = {
    GgmlType.Q4_0,
    GgmlType.Q4_1,
    GgmlType.Q5_0,
    GgmlType.Q5_1,
    GgmlType.Q8_0,
    GgmlType.Q8_1,
    GgmlType.Q2_K,
    GgmlType.Q3_K,
    GgmlType.Q4_K,
    GgmlType.Q5_K,
    GgmlType.Q6_K,
    GgmlType.Q8_K,
}

# (block_size_in_elements, bytes_per_block) — ggml.c type tables.
#   Q4_0: fp16 d + 16B nibbles                = 2 + 16 = 18
#   Q4_1: fp16 d + fp16 m + 16B nibbles       = 4 + 16 = 20
#   Q5_0: fp16 d + u32 qh + 16B nibbles       = 2 + 4 + 16 = 22
#   Q5_1: fp16 d + fp16 m + u32 qh + 16B      = 4 + 4 + 16 = 24
#   Q8_0: fp16 d + 32 int8                    = 2 + 32 = 34
#   Q8_1: f32 d + f32 s + 32 int8             = 8 + 32 = 40
#   Q2_K: 16B scales + 64B qs + fp16 d + dmin = 84   (sys/src/lib.rs:2977)
#   Q3_K: 32B hmask + 64B qs + 12B scales + d = 110  (sys/src/lib.rs:3040)
#   Q4_K: d + dmin + 12B scales + 128B qs     = 144
#   Q5_K: d + dmin + 12B scales + 32B qh + 128B qs = 176
#   Q6_K: 128B ql + 64B qh + 16B scales + d   = 210
#   Q8_K: f32 d + 256 int8 + 16 i16 bsums     = 292
_TYPE_LAYOUT: dict[GgmlType, tuple[int, int]] = {
    GgmlType.F32: (1, 4),
    GgmlType.F16: (1, 2),
    GgmlType.Q4_0: (32, 18),
    GgmlType.Q4_1: (32, 20),
    GgmlType.Q5_0: (32, 22),
    GgmlType.Q5_1: (32, 24),
    GgmlType.Q8_0: (32, 34),
    GgmlType.Q8_1: (32, 40),
    GgmlType.Q2_K: (QK_K, 84),
    GgmlType.Q3_K: (QK_K, 110),
    GgmlType.Q4_K: (QK_K, 144),
    GgmlType.Q5_K: (QK_K, 176),
    GgmlType.Q6_K: (QK_K, 210),
    GgmlType.Q8_K: (QK_K, 292),
    GgmlType.I8: (1, 1),
    GgmlType.I16: (1, 2),
    GgmlType.I32: (1, 4),
}


def block_size(t: GgmlType) -> int:
    """Elements per block (ggml_blck_size)."""
    return _TYPE_LAYOUT[t][0]


def type_size(t: GgmlType) -> int:
    """Bytes per block (ggml_type_size)."""
    return _TYPE_LAYOUT[t][1]


def data_size(t: GgmlType, n_elements: int) -> int:
    """Bytes occupied by n_elements of type t (format/loader.rs:122-124)."""
    bs, ts = _TYPE_LAYOUT[t]
    if n_elements % bs != 0:
        raise ValueError(f"{n_elements} elements not a multiple of {t} block size {bs}")
    return (n_elements // bs) * ts


class ContainerType:
    """GGML container family (crates/ggml/src/lib.rs:37-118).

    One of "ggml" (unversioned), "ggmf", "ggjt", "ggla" — the latter three
    carry a u32 version after the magic.
    """

    __slots__ = ("kind", "version")

    def __init__(self, kind: str, version: int | None = None):
        assert kind in ("ggml", "ggmf", "ggjt", "ggla", "gguf")
        self.kind = kind
        self.version = version

    def __eq__(self, other):
        return (
            isinstance(other, ContainerType)
            and self.kind == other.kind
            and self.version == other.version
        )

    def __hash__(self):
        return hash((self.kind, self.version))

    def __repr__(self):
        if self.version is None:
            return f"ContainerType({self.kind!r})"
        return f"ContainerType({self.kind!r}, v{self.version})"

    @property
    def support_mmap(self) -> bool:
        # lib.rs:49-56 — only Ggjt aligns tensor data (and therefore
        # supports zero-copy loads). GGUF (successor format) aligns too.
        return self.kind in ("ggjt", "gguf")

    @property
    def has_scored_vocab(self) -> bool:
        # format/loader.rs:189-195 — Ggmf and Ggjt read an f32 score per token.
        return self.kind in ("ggmf", "ggjt")

    @property
    def aligned_tensors(self) -> bool:
        # format/loader.rs:202-207 — Ggjt and Ggla align tensor data to 32B.
        return self.kind in ("ggjt", "ggla", "gguf")

    @classmethod
    def read(cls, f) -> "ContainerType":
        head = f.read(4)
        if len(head) < 4:  # typed error, not struct.error, on truncation
            raise FormatMagicError(0)
        magic = struct.unpack("<I", head)[0]
        if magic == FILE_MAGIC_GGML:
            return cls("ggml")
        kind = {
            FILE_MAGIC_GGMF: "ggmf",
            FILE_MAGIC_GGJT: "ggjt",
            FILE_MAGIC_GGLA: "ggla",
        }.get(magic)
        if kind is None:
            raise FormatMagicError(magic)
        ver = f.read(4)
        if len(ver) < 4:
            raise FormatMagicError(magic)
        return cls(kind, struct.unpack("<I", ver)[0])

    def write(self, f) -> None:
        magic = {
            "ggml": FILE_MAGIC_GGML,
            "ggmf": FILE_MAGIC_GGMF,
            "ggjt": FILE_MAGIC_GGJT,
            "ggla": FILE_MAGIC_GGLA,
        }[self.kind]
        f.write(struct.pack("<I", magic))
        if self.kind != "ggml":
            f.write(struct.pack("<I", self.version))

    def is_supported(self) -> bool:
        # format/loader.rs:167-173
        if self.kind == "ggml":
            return True
        if self.kind == "ggmf":
            return self.version == 1
        if self.kind == "ggjt":
            return self.version in (1, 2, 3)
        if self.kind == "ggla":
            return self.version == 1
        return False


class FormatMagicError(ValueError):
    def __init__(self, magic: int):
        as_bytes = struct.pack("<I", magic)
        super().__init__(f"invalid file magic number: {magic:x} ({as_bytes!r})")
        self.magic = magic


class FileTypeFormat(enum.IntEnum):
    """llama_ftype — file-level quantization scheme (sys/src/llama.rs:16-32)."""

    F32 = 0
    MostlyF16 = 1
    MostlyQ4_0 = 2
    MostlyQ4_1 = 3
    MostlyQ4_1SomeF16 = 4
    MostlyQ8_0 = 7
    MostlyQ5_0 = 8
    MostlyQ5_1 = 9
    MostlyQ2_K = 10
    MostlyQ3_K_S = 11
    MostlyQ3_K_M = 12
    MostlyQ3_K_L = 13
    MostlyQ4_K_S = 14
    MostlyQ4_K_M = 15
    MostlyQ5_K_S = 16
    MostlyQ5_K_M = 17
    MostlyQ6_K = 18

    def __str__(self) -> str:
        return self.name.lower()


@dataclass(frozen=True)
class FileType:
    """ftype ↔ (format, quantization_version) codec (llm-base/loader.rs:24-56).

    encoded = quantization_version * 1000 + llama_ftype
    """

    format: FileTypeFormat = FileTypeFormat.MostlyF16
    quantization_version: int = 0

    def to_i32(self) -> int:
        return self.quantization_version * QNT_VERSION_FACTOR + int(self.format)

    @classmethod
    def from_i32(cls, value: int) -> "FileType":
        fmt = FileTypeFormat(value % QNT_VERSION_FACTOR)
        return cls(format=fmt, quantization_version=value // QNT_VERSION_FACTOR)

    def __str__(self) -> str:
        return f"{self.format}_qnt{self.quantization_version}"


# ftype of the weight tensors implied by each file-level format (for the
# quantizer; quantize.rs:224-244 only permits the non-K targets).
FILE_TYPE_TO_ELEMENT_TYPE: dict[FileTypeFormat, GgmlType] = {
    FileTypeFormat.F32: GgmlType.F32,
    FileTypeFormat.MostlyF16: GgmlType.F16,
    FileTypeFormat.MostlyQ4_0: GgmlType.Q4_0,
    FileTypeFormat.MostlyQ4_1: GgmlType.Q4_1,
    FileTypeFormat.MostlyQ8_0: GgmlType.Q8_0,
    FileTypeFormat.MostlyQ5_0: GgmlType.Q5_0,
    FileTypeFormat.MostlyQ5_1: GgmlType.Q5_1,
    FileTypeFormat.MostlyQ2_K: GgmlType.Q2_K,
    FileTypeFormat.MostlyQ3_K_M: GgmlType.Q3_K,
    FileTypeFormat.MostlyQ4_K_M: GgmlType.Q4_K,
    FileTypeFormat.MostlyQ5_K_M: GgmlType.Q5_K,
    FileTypeFormat.MostlyQ6_K: GgmlType.Q6_K,
}

ELEMENT_TYPE_TO_FILE_TYPE: dict[GgmlType, FileTypeFormat] = {
    GgmlType.F32: FileTypeFormat.F32,
    GgmlType.F16: FileTypeFormat.MostlyF16,
    GgmlType.Q4_0: FileTypeFormat.MostlyQ4_0,
    GgmlType.Q4_1: FileTypeFormat.MostlyQ4_1,
    GgmlType.Q8_0: FileTypeFormat.MostlyQ8_0,
    GgmlType.Q5_0: FileTypeFormat.MostlyQ5_0,
    GgmlType.Q5_1: FileTypeFormat.MostlyQ5_1,
    GgmlType.Q2_K: FileTypeFormat.MostlyQ2_K,
    GgmlType.Q3_K: FileTypeFormat.MostlyQ3_K_M,
    GgmlType.Q4_K: FileTypeFormat.MostlyQ4_K_M,
    GgmlType.Q5_K: FileTypeFormat.MostlyQ5_K_M,
    GgmlType.Q6_K: FileTypeFormat.MostlyQ6_K,
}
