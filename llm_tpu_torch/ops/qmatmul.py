"""Fused dequantize -> matmul: y = x @ W for quantized or dense weights.

The counterpart of `llm_tpu/ops/qmatmul.py`. A quantized weight on a CUDA
tensor goes through the hand-written kernel `csrc/qmatmul.cu` (the port of
the TPU kernels K1 and K3); on a CPU tensor it goes through
`qmatmul_plain`, which is `x @ dequant(W)` in f32 like the reference's XLA
fallback. The kernel rounds x and each dequantized weight to bf16 and
accumulates in f32, as the TPU kernel does, so kernel and plain version
agree to bf16 rounding. There is no fallback: a CUDA tensor that the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from llm_tpu_torch import _build
from llm_tpu_torch.ops.packing import FORMAT_IDS, QuantTensor, dequant

LAUNCHES = 0  # kernel launches through qmatmul (plain calls do not count)

_C = ctypes.c_int
_P = ctypes.c_void_p
_SIGNATURES = {
    "qmatmul_launch": [_C, _C, _C, _P, _P, _P, _P, _P, _P, _P,
                       _C, _C, _C, _C, _C, _C, _P],
}
_THREADS = 128  # output columns per block (csrc/qmatmul.cu kThreads)
_UNIT = 32  # K elements per dequant unit (kUnit)
_CHUNK_UNITS = 8  # units of x staged per pass (kChunk / kUnit)


def qmatmul_plain(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """x [M, K] @ dequant(w) [K, R] -> [M, R] f32: the plain version of the
    kernel (what the reference's XLA fallback computes)."""
    return x.to(torch.float32) @ dequant(w)


def _plan(w: QuantTensor, M: int, device) -> tuple[int, int, int]:
    """(rows of x per thread, K splits, 32-element units per split): split
    K only when the (column, row) blocks alone would leave SMs idle."""
    mt = 1 if M == 1 else 16
    blocks = (w.r_padded // _THREADS) * math.ceil(M / mt)
    n_units = w.k_padded // _UNIT
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = 1
    if blocks < 2 * sms:
        splits = min(math.ceil(4 * sms / blocks), n_units)
    ups = math.ceil(n_units / splits)
    ups = math.ceil(ups / _CHUNK_UNITS) * _CHUNK_UNITS  # whole x chunks
    return mt, math.ceil(n_units / ups), ups


def qmatmul_cuda(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """Launch csrc/qmatmul.cu: x [M, K] (any float) @ dequant(w) -> [M, R]
    f32. w's planes are one layer (a view of stacked planes is fine)."""
    global LAUNCHES
    dev = x.device
    if x.dim() != 2 or x.shape[1] != w.k:
        raise ValueError(f"qmatmul: x {tuple(x.shape)} vs weight K={w.k}")
    Kp, Rp = w.k_padded, w.r_padded
    planes = [p for p in w.planes() if p is not None]
    for p in planes:
        if p.device != dev or p.dim() != 2 or not p.is_contiguous():
            raise ValueError("qmatmul: weight planes must be contiguous 2-D "
                             f"tensors on {dev}")
    if Rp % _THREADS or Kp % _UNIT:
        raise ValueError(f"qmatmul: padded shape ({Kp}, {Rp}) not supported")
    if w.fmt.name.endswith("_k") and w.scale_packed:
        raise ValueError("qmatmul: K-quant scales must be f32")
    M = x.shape[0]
    xb = torch.zeros((M, Kp), dtype=torch.bfloat16, device=dev)
    xb[:, : w.k] = x
    y = torch.empty((M, w.r), dtype=torch.float32, device=dev)
    if M == 0:
        return y
    mt, splits, ups = _plan(w, M, dev)
    part = (torch.empty((splits, M, Rp), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    lib = _build.load("qmatmul", _SIGNATURES)
    ptr = _build.ptr
    err = lib.qmatmul_launch(
        FORMAT_IDS[w.fmt_name], int(w.scale_packed), mt, ptr(xb), ptr(w.lo),
        ptr(w.hi), ptr(w.scale), ptr(w.bias), ptr(y), ptr(part), M, Kp, Rp,
        w.r, splits, ups, _build.stream_ptr(dev),
    )
    _build.check(err, "qmatmul_launch")
    LAUNCHES += 1
    return y


def qmatmul(x: torch.Tensor, w, layer=None) -> torch.Tensor:
    """y = x @ W for dense ([K, R] tensor) or quantized (QuantTensor) W.

    x: [..., K] float; returns [..., R] float32. `layer` selects one layer
    of layer-stacked weights (a view: the kernel reads the layer's planes
    in place).
    """
    if layer is not None:
        w = w.layer(layer) if isinstance(w, QuantTensor) else w[layer]
    if isinstance(w, QuantTensor):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = qmatmul_cuda(x2, w) if x2.is_cuda else qmatmul_plain(x2, w)
        return y.reshape(*lead, w.r)
    return x.to(torch.float32) @ w.to(torch.float32)


def quant_rows_lookup(w, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: dequantize the selected logical rows.

    ggml get_rows analog: for a table stored K-major ([K-planes, R=vocab]),
    gather columns `ids` then dequantize. Returns [len(ids), K] float32.
    """
    if isinstance(w, QuantTensor):

        def cols(p):
            return None if p is None else p[:, ids]

        sub = QuantTensor(w.fmt_name, w.k, ids.shape[0], cols(w.lo),
                          cols(w.hi), cols(w.scale), cols(w.bias))
        return dequant(sub).t()
    return w[:, ids].to(torch.float32).t()
