"""GGML container writer.

Writes GGML (bare) and GGJT v3 containers, matching the reference saver
(llm/crates/ggml/src/format/saver.rs:86-160):

    magic [+version] -> hyperparameters -> vocab -> tensors (32B-aligned for ggjt)

A scored vocabulary may not be written to a bare GGML container
(saver.rs:96-100).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, Sequence

import numpy as np

from llm_tpu_torch.ggml.types import ContainerType, GgmlType, data_size


class SaveError(ValueError):
    pass


class GgmlWriter:
    def __init__(self, f: BinaryIO, container: ContainerType):
        if container.kind not in ("ggml", "ggjt"):
            raise SaveError(f"cannot save container type {container!r}")
        self.f = f
        self.container = container

    def write_header(
        self,
        hyperparameter_bytes: bytes,
        vocabulary: Iterable[tuple[bytes, float]],
    ) -> None:
        f = self.f
        self.container.write(f)
        f.write(hyperparameter_bytes)
        for token, score in vocabulary:
            if score != 0.0 and not self.container.has_scored_vocab:
                raise SaveError("container type does not support vocabulary scoring")
            f.write(struct.pack("<I", len(token)))
            f.write(token)
            if self.container.has_scored_vocab:
                f.write(struct.pack("<f", score))

    def write_tensor(
        self,
        name: str,
        element_type: GgmlType,
        dims: Sequence[int],
        data: bytes | np.ndarray,
    ) -> None:
        """dims are in ggml order (dims[0] = contiguous row length)."""
        f = self.f
        n_elements = 1
        for d in dims:
            n_elements *= d
        expected = data_size(element_type, n_elements)
        raw = np.asarray(data, dtype=np.uint8).tobytes() if not isinstance(data, bytes) else data
        if len(raw) != expected:
            raise SaveError(
                f"invariant broken: tensor {name} has {len(raw)} bytes, expected {expected}"
            )
        name_bytes = name.encode("utf-8")
        f.write(struct.pack("<iiI", len(dims), len(name_bytes), int(element_type)))
        for d in dims:
            f.write(struct.pack("<i", d))
        f.write(name_bytes)
        if self.container.aligned_tensors:
            pos = f.tell()
            pad = (-pos) % 32
            f.write(b"\x00" * pad)
        f.write(raw)
