"""GGML interchange layer: type metadata, block-quant codecs, container IO.

This is the host-side half of the framework: everything needed to read and
write the GGML family of on-disk formats (GGML / GGMF / GGJT / GGLA) and to
transcode between ggml block-quantized byte layouts and the packed on-device
layouts used by the TPU kernels.

Reference behavior: llm/crates/ggml/src/format/{loader,saver}.rs
and the quant block layouts enumerated in
llm/crates/ggml/sys/src/lib.rs (bindgen of ggml.c / k_quants.c).
"""

from llm_tpu_torch.ggml.types import (
    GgmlType,
    ContainerType,
    FileType,
    FileTypeFormat,
    type_size,
    block_size,
    data_size,
    QNT_VERSION,
    QNT_VERSION_FACTOR,
)
from llm_tpu_torch.ggml.quant import dequantize, quantize, quantize_with_hist
from llm_tpu_torch.ggml.reader import GgmlReader, TensorInfo, FormatError
from llm_tpu_torch.ggml.writer import GgmlWriter

__all__ = [
    "GgmlType",
    "ContainerType",
    "FileType",
    "FileTypeFormat",
    "type_size",
    "block_size",
    "data_size",
    "QNT_VERSION",
    "QNT_VERSION_FACTOR",
    "dequantize",
    "quantize",
    "quantize_with_hist",
    "GgmlReader",
    "TensorInfo",
    "FormatError",
    "GgmlWriter",
]
