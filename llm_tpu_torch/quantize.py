"""Model quantizer: f32/f16 checkpoint -> block-quantized checkpoint.

The counterpart of `llm_tpu/quantize.py` (host numpy, the same bytes). It
mirrors llm/crates/llm-base/src/quantize.rs:
- the reference's targets Q4_0/Q4_1/Q5_0/Q5_1/Q8_0 (quantize.rs:224-244),
  plus the K-quants Q2_K..Q6_K as an extension (see VALID_TARGETS)
- a tensor is quantized iff it is 2-D, matches the architecture's
  quantize_tensors() regexes, is not in skip_quantize_tensors(), and is
  stored F32/F16 (quantize.rs:332-361); everything else passes through
- the file-level ftype is rewritten to the target with QNT_VERSION
  (quantize.rs:176-181)
- per-tensor histograms are reported through the progress callback
  (QuantizeProgress, quantize.rs:21-67)
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from llm_tpu_torch.ggml.quant import quantize_with_hist
from llm_tpu_torch.ggml.reader import GgmlReader
from llm_tpu_torch.ggml.types import (
    ELEMENT_TYPE_TO_FILE_TYPE,
    QNT_VERSION,
    ContainerType,
    FileType,
    GgmlType,
)
from llm_tpu_torch.ggml.writer import GgmlWriter
from llm_tpu_torch.models.spec import get_arch

VALID_TARGETS = (
    GgmlType.Q4_0,
    GgmlType.Q4_1,
    GgmlType.Q5_0,
    GgmlType.Q5_1,
    GgmlType.Q8_0,
    # an extension beyond quantize.rs:224-244: K-quant targets via the
    # ggml_quantize_q2_K..q6_K-equivalent encoders (ggml/quant.py). A
    # tensor whose row length is not a multiple of QK_K=256 falls back to
    # Q8_0, mirroring llama.cpp's incompatible-tensor fallback.
    GgmlType.Q2_K,
    GgmlType.Q3_K,
    GgmlType.Q4_K,
    GgmlType.Q5_K,
    GgmlType.Q6_K,
)

_K_QUANTS = (GgmlType.Q2_K, GgmlType.Q3_K, GgmlType.Q4_K,
             GgmlType.Q5_K, GgmlType.Q6_K)


class QuantizeError(ValueError):
    pass


@dataclass
class QuantizeProgress:
    """kind in {hyperparameters_loaded, tensor_loading, tensor_quantizing,
    tensor_quantized, tensor_skipped, finished}."""

    kind: str
    name: str = ""
    element_type: Optional[GgmlType] = None
    dims: tuple = ()
    original_size: int = 0
    reduced_size: int = 0
    history: Optional[np.ndarray] = None


def quantize(
    source: str | Path,
    destination: str | Path,
    architecture: str,
    target: GgmlType,
    container: Optional[ContainerType] = None,
    progress: Optional[Callable[[QuantizeProgress], None]] = None,
) -> None:
    """Quantize a checkpoint. Containers mix freely: classic GGML/GGJT or
    GGUF on either side (GGUF is selected by the source file's magic and by
    a `.gguf` destination suffix or container=("gguf", 3)); GGUF metadata
    passes through verbatim when both sides are GGUF."""
    from llm_tpu_torch.ggml.gguf import GgufReader, is_gguf

    if target not in VALID_TARGETS:
        raise QuantizeError(
            f"invalid quantization target {target}; valid targets: "
            f"{[str(t) for t in VALID_TARGETS]}"
        )
    src_gguf = is_gguf(source)
    dst_gguf = (container is not None and container.kind == "gguf") or (
        container is None and str(destination).endswith(".gguf")
    )
    container = container or ContainerType("ggjt", 3)
    progress = progress or (lambda ev: None)
    arch = get_arch(architecture)

    import re

    quant_res = [re.compile(p) for p in arch.quantize_patterns]
    skip_res = [re.compile(p) for p in arch.skip_quantize_patterns]

    if src_gguf:
        reader = GgufReader(source).load(architecture)
    else:
        reader = GgmlReader(source).load(
            lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f))
        )
    hp = reader.hyperparameters
    progress(QuantizeProgress("hyperparameters_loaded"))

    hp.file_type = FileType(
        format=ELEMENT_TYPE_TO_FILE_TYPE[target],
        quantization_version=QNT_VERSION,
    )

    total_hist = np.zeros(16, dtype=np.int64)
    total_orig = total_new = 0

    with open(destination, "wb") as f:
        if dst_gguf:
            w = _GgufQuantizeSink(f, reader, architecture, hp, src_gguf)
        else:
            w = GgmlWriter(f, container)
            hb = io.BytesIO()
            hp.write_ggml(hb)
            vocab = list(
                zip(reader.vocabulary.tokens, reader.vocabulary.scores)
            )
            if not container.has_scored_vocab:
                vocab = [(t, 0.0) for t, _ in vocab]
            w.write_header(hb.getvalue(), vocab)

        for name, info in reader.tensors.items():
            raw = reader.fetch(name)
            progress(
                QuantizeProgress(
                    "tensor_loading",
                    name=name,
                    element_type=info.element_type,
                    dims=info.dims,
                )
            )
            should_quantize = (
                info.n_dims == 2
                and info.element_type in (GgmlType.F32, GgmlType.F16)
                and any(r.fullmatch(name) or r.match(name) for r in quant_res)
                and not any(r.fullmatch(name) for r in skip_res)
            )
            if should_quantize:
                progress(QuantizeProgress("tensor_quantizing", name=name))
                if info.element_type == GgmlType.F16:
                    data = (
                        np.frombuffer(raw, dtype=np.float16, count=info.n_elements)
                        .astype(np.float32)
                    )
                else:
                    data = np.frombuffer(raw, dtype=np.float32, count=info.n_elements)
                ttype = target
                if target in _K_QUANTS and info.dims[0] % 256 != 0:
                    ttype = GgmlType.Q8_0  # K-quant superblocks must not
                    #                        straddle rows (QK_K=256)
                qbytes, hist = quantize_with_hist(ttype, data)
                total_hist += hist
                total_orig += len(raw)
                total_new += len(qbytes)
                progress(
                    QuantizeProgress(
                        "tensor_quantized",
                        name=name,
                        element_type=ttype,
                        original_size=len(raw),
                        reduced_size=len(qbytes),
                        history=hist,
                    )
                )
                w.write_tensor(name, ttype, info.dims, qbytes)
            else:
                progress(QuantizeProgress("tensor_skipped", name=name))
                total_orig += len(raw)
                total_new += len(raw)
                w.write_tensor(name, info.element_type, info.dims, bytes(raw))

        if dst_gguf:
            w.finish()

    progress(
        QuantizeProgress(
            "finished",
            original_size=total_orig,
            reduced_size=total_new,
            history=total_hist,
        )
    )


class _GgufQuantizeSink:
    """GgmlWriter-shaped sink that emits GGUF v3.

    GGUF source: metadata passes through verbatim (only general.file_type is
    rewritten — that is what llama.cpp's quantize does) and tensors keep
    their original GGUF names. Classic source: metadata is synthesized from
    the hyperparameters + scored vocab and classic names are translated to
    the gguf.md convention."""

    def __init__(self, f, reader, architecture: str, hp, src_gguf: bool):
        from llm_tpu_torch.ggml.gguf import GgufWriter, arch_metadata, gguf_name_fn

        self._w = GgufWriter(f)
        if src_gguf:
            md = dict(reader.metadata)
            md["general.file_type"] = int(hp.file_type.format)
            self._name = lambda n: reader.source_names.get(n, n)
        else:
            md = arch_metadata(architecture, hp, reader.vocabulary)
            self._name = gguf_name_fn(
                architecture,
                {"falcon.attention.head_count_kv": hp.n_head_kv},
            )
        for k, v in md.items():
            self._w.add_metadata(k, v)

    def write_tensor(self, name, element_type, dims, data) -> None:
        self._w.add_tensor(self._name(name), element_type, dims, data)

    def finish(self) -> None:
        self._w.finish()
