"""Decode GGML block bytes on the card with the hand-written codec kernel.

The counterpart of `llm_tpu/native/` (`__init__.py` and `codecs.cpp`), the
JAX package's C++ codec library, which decodes all ten block formats on the
host at load. Here the kernel `csrc/codecs.cu` decodes them on the card:
`decode(t, raw, K, R)` takes the raw bytes of one GGML tensor of R rows of
K elements, already on the card as a uint8 tensor, and returns the
canonical decoding of `ggml/quant.decode_blocks` as `ops/packing.
decode_ggml` returns it:

    q      int32 [R, K]
    scale  f32   [R, K / g]
    bias   f32   [R, K / g], or None for the formats without one

bit-equal to it. `ops/packing.pack_decoded` then builds the planes, as the
reference's `llm_transcode` does in its same pass on the host.

There is no fallback: a tensor on the CPU is refused (the CPU decodes with
`ops/packing.decode_plain`), and a build or launch failure raises. The
reference's `llm_dequantize` has no counterpart: every caller of
`dequantize` in the port hands its result to host numpy (ROADMAP §C).
"""

from __future__ import annotations

import ctypes

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ggml.types import GgmlType, block_size, type_size
from llm_tpu_torch.ops.packing import FORMATS

LAUNCHES = 0  # codec kernel launches through `decode`

_P = ctypes.c_void_p
_SIGNATURES = {
    "codecs_decode": [ctypes.c_int, _P, ctypes.c_longlong, _P, _P, _P, _P],
}


def decode(t: GgmlType, raw: torch.Tensor, K: int, R: int):
    """(q int32 [R, K], scale f32 [R, K/g], bias f32 [R, K/g] | None) of
    the R x K tensor of type `t` whose block bytes `raw` (uint8, 1-D,
    contiguous, on a CUDA device) holds, decoded by one kernel launch."""
    global LAUNCHES
    if t not in FORMATS:
        raise NotImplementedError(f"native.decode: {t}")
    if not raw.is_cuda:
        raise ValueError("native.decode takes a CUDA tensor; the CPU decodes "
                         "with ops/packing.decode_plain")
    bs, ts = block_size(t), type_size(t)
    if K % bs:
        raise ValueError(f"native.decode: K={K} is not whole {t} blocks")
    n_blocks = R * (K // bs)
    if (raw.dtype != torch.uint8 or raw.dim() != 1 or not raw.is_contiguous()
            or raw.numel() != n_blocks * ts or raw.data_ptr() % 4):
        raise ValueError(
            f"native.decode: raw must be {n_blocks * ts} contiguous, 4-byte "
            f"aligned uint8 bytes, got {raw.dtype} {tuple(raw.shape)}")
    g, has_bias = FORMATS[t].gsize, FORMATS[t].has_bias
    dev = raw.device
    q = torch.empty((R, K), dtype=torch.int32, device=dev)
    scale = torch.empty((R, K // g), dtype=torch.float32, device=dev)
    bias = (torch.empty((R, K // g), dtype=torch.float32, device=dev)
            if has_bias else None)
    lib = _build.load("codecs", _SIGNATURES)
    ptr = _build.ptr
    _build.check(lib.codecs_decode(int(t), ptr(raw), n_blocks, ptr(q),
                                   ptr(scale), ptr(bias),
                                   _build.stream_ptr(dev)),
                 f"codecs_decode ({t})")
    LAUNCHES += 1
    return q, scale, bias
