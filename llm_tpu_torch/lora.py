"""LoRA adapters: load-time weight patching from GGLA files.

The counterpart of `llm_tpu/lora.py`, which mirrors
llm/crates/llm-base/src/lora.rs: a GGLA container holds
hyperparameters {r, alpha} (scaling = alpha/r) and pairs of tensors
`{name}.loraA` / `{name}.loraB`; patching computes

    w' = w + (B . A) * scaling         (lora.rs:117-127)

The reference builds a ggml mini-graph and memcpys the result over the
weight (requantizing through ggml_add on quantized tensors). Here the patch
is plain numpy at load time: dequantize w, add the scaled update, re-encode
to the original element type — the packed device planes are then built from
the patched bytes (`models/params.WeightSource._raw`), so a patched
quantized weight runs through the same kernel as any other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Optional

import numpy as np

from llm_tpu_torch.ggml.quant import dequantize, quantize
from llm_tpu_torch.ggml.reader import GgmlReader, TensorInfo
from llm_tpu_torch.ggml.types import GgmlType


@dataclass
class LoraParameters:
    """GGLA hyperparameters (lora.rs:15-26)."""

    r: int
    alpha: int

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.r)


def _read_ggla_hparams(f: BinaryIO) -> tuple[LoraParameters, int]:
    r, alpha = struct.unpack("<ii", f.read(8))
    return LoraParameters(r=r, alpha=alpha), 0  # no vocabulary (lora.rs:41-44)


class LoraAdapter:
    """One loaded GGLA file, applied lazily per tensor (lora.rs:56-142)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.reader = GgmlReader(path).load(_read_ggla_hparams)
        self.params: LoraParameters = self.reader.hyperparameters
        self.scaling = self.params.scaling
        self.tensors_to_patch = {
            name.rsplit(".", 1)[0]
            for name in self.reader.tensors
            if name.endswith((".loraA", ".loraB"))
        }

    def _dense(self, name: str) -> np.ndarray:
        """Fetch a LoRA factor as f32, numpy shape = reversed ggml dims."""
        info = self.reader.tensors[name]
        flat = dequantize(info.element_type, self.reader.fetch(name), info.n_elements)
        return flat.reshape(tuple(reversed(info.dims)))

    def patch(
        self, name: str, info: TensorInfo, data: np.ndarray
    ) -> Optional[tuple[TensorInfo, bytes]]:
        """Return patched (info, bytes) for `name`, or None if not patched."""
        if name not in self.tensors_to_patch:
            return None
        a = self._dense(f"{name}.loraA")  # [K, r]   (ggml dims (r, K))
        b = self._dense(f"{name}.loraB")  # [R, r]   (ggml dims (r, R))
        K = info.dims[0]
        R = info.dims[1] if len(info.dims) > 1 else 1
        ba = (b @ a.T) * self.scaling  # [R, K]

        w = dequantize(info.element_type, data, info.n_elements).reshape(R, K)
        w = (w + ba).astype(np.float32)

        t = info.element_type
        if t == GgmlType.F32:
            out = w.tobytes()
        elif t == GgmlType.F16:
            out = w.astype(np.float16).tobytes()
        else:
            out = quantize(t, w.ravel())
        return info, out
