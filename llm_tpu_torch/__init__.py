"""llm_tpu_torch: the PyTorch/CUDA port of llm_tpu.

Loads GGML/GGJT block-quantized checkpoints and runs them with hand-written
CUDA kernels for the dequantizing matmul and the dense and paged decode
attention (`csrc/`), beside plain PyTorch versions of each that the CPU
uses; `serve`/`paged`/`server` batch many streams behind HTTP. Entry
points run on the card unless the caller passes `device="cpu"`. The JAX
package `llm_tpu` is the reference this port is held against.
"""

__version__ = "0.1.0"

from llm_tpu_torch.ggml.types import (
    ContainerType,
    FileType,
    FileTypeFormat,
    GgmlType,
)

__all__ = [
    "GgmlType",
    "FileType",
    "FileTypeFormat",
    "ContainerType",
    "load",
    "Model",
    "ModelParameters",
    "InferenceSession",
    "InferenceSessionConfig",
    "InferenceRequest",
    "InferenceParameters",
    "OutputRequest",
    "TokenizerSource",
    "Prompt",
    "SUPPORTED_ARCHITECTURES",
]


def __getattr__(name):
    """Lazy public API: importing the package loads no model code."""
    if name in ("load", "Model", "ModelParameters", "RoPEOverrides"):
        import llm_tpu_torch.loader as m

        return getattr(m, name)
    if name in (
        "InferenceSession",
        "InferenceSessionConfig",
        "InferenceRequest",
        "InferenceParameters",
        "InferenceStats",
        "InferenceError",
        "InferenceFeedback",
        "InferenceResponse",
        "OutputRequest",
        "ModelKVMemoryType",
    ):
        import llm_tpu_torch.session as m

        return getattr(m, name)
    if name in ("TokenizerSource", "Tokenizer", "Prompt", "TokenBias"):
        import llm_tpu_torch.tokenizer as m

        return getattr(m, name)
    if name in ("SUPPORTED_ARCHITECTURES", "ModelSpec", "get_arch"):
        import llm_tpu_torch.models.spec as m

        return getattr(m, name)
    raise AttributeError(f"module 'llm_tpu_torch' has no attribute {name!r}")
