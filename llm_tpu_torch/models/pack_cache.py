"""Pre-packed checkpoint cache: repeat loads skip the transcode.

The counterpart of `llm_tpu/models/pack_cache.py`. `load()` decodes the
GGML blocks and packs them into the kernel's K-major planes (on the card
for the 32-block formats, in host numpy for the K-quants). The result is a
pure function of (file, packing knobs), so `llm-tpu-torch pack` writes it
to disk once and later loads of the same file become a read and a
host-to-device copy.

On-disk layout (`<model>.torchpack/` next to the checkpoint; the JAX
package's `.tpupack` holds its own planes and is never read here):

    manifest.json   version, validity key, recursive tree spec
    a<NNN>.npy      one per tensor leaf (np.save); bf16 leaves as their
                    16-bit words, int32 word planes as they are

The key ties the cache to the source file (size and mtime) and to every
knob that changes what the loader builds: the GQA override and the dense
upcast (LLM_TPU_DENSE_UPCAST and LLM_TPU_DENSE_UPCAST_MAX_MB, which the
JAX package's key leaves out although its cache also skips the upcast).
A mismatched or corrupt cache is ignored, never trusted; LoRA loads bypass
it (their planes are patched).
"""

from __future__ import annotations

import json
import os
from dataclasses import fields
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from llm_tpu_torch.models.params import LayerParams, ModelParams
from llm_tpu_torch.ops.packing import QuantTensor, QuantTensorC

VERSION = 1
SUFFIX = ".torchpack"
_NODE_TYPES = {"ModelParams": ModelParams, "LayerParams": LayerParams}
# torch dtypes stored through a numpy view of the same width
_VIEWS = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16)}


def pack_path(model_path) -> Path:
    p = Path(model_path)
    return p.with_name(p.name + SUFFIX)


def cache_key(model_path, n_gqa=None) -> dict:
    st = os.stat(model_path)
    return {
        "version": VERSION,
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "n_gqa": n_gqa,
        "dense_upcast": os.environ.get("LLM_TPU_DENSE_UPCAST", "0"),
        "dense_upcast_max_mb": os.environ.get("LLM_TPU_DENSE_UPCAST_MAX_MB",
                                              "256"),
    }


def _save_node(obj, arrays: list, counter: list) -> dict:
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, QuantTensor):
        return {
            "t": "quant",
            "fmt": obj.fmt_name,
            "k": obj.k,
            "r": obj.r,
            "splits": obj.splits,
            "planes": {
                n: _save_node(getattr(obj, n), arrays, counter)
                for n in ("lo", "hi", "scale", "bias")
            },
        }
    if isinstance(obj, QuantTensorC):
        return {
            "t": "quantc",
            "fmt": obj.fmt_name,
            "k": obj.k,
            "r": obj.r,
            "kp": obj.kp,
            "rp": obj.rp,
            "tile_k": obj.tile_k,
            "tile_r": obj.tile_r,
            "scale_packed": obj.scale_packed,
            "splits": obj.splits,
            "buf": _save_node(obj.buf, arrays, counter),
        }
    if isinstance(obj, (ModelParams, LayerParams)):
        return {
            "t": type(obj).__name__,
            "fields": {
                f.name: _save_node(getattr(obj, f.name), arrays, counter)
                for f in fields(obj)
            },
        }
    # tensor leaf; numpy has no bfloat16, so such a leaf keeps its bits
    t = obj.detach().cpu().contiguous()
    spec = {"t": "array", "file": f"a{counter[0]:03d}.npy"}
    counter[0] += 1
    if t.dtype in _VIEWS:
        name, np_dtype, as_int = _VIEWS[t.dtype]
        spec["view"] = name
        a = t.view(as_int).numpy().view(np_dtype)
    else:
        a = t.numpy()
    arrays.append((spec["file"], a))
    return spec


def _to_tensor(spec: dict, a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if spec.get("view") == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def _splits(s):
    return None if s is None else tuple(tuple(x) for x in s)


def _load_node(spec: dict, base: Path, device):
    t = spec["t"]
    if t == "none":
        return None
    if t == "array":
        return _to_tensor(spec, np.load(base / spec["file"]), device)
    if t == "quant":
        planes = {n: _load_node(s, base, device)
                  for n, s in spec["planes"].items()}
        return QuantTensor(spec["fmt"], spec["k"], spec["r"],
                           splits=_splits(spec["splits"]), **planes)
    if t == "quantc":
        return QuantTensorC(
            spec["fmt"], spec["k"], spec["r"], spec["kp"], spec["rp"],
            spec["tile_k"], spec["tile_r"], spec["scale_packed"],
            _load_node(spec["buf"], base, device),
            _splits(spec["splits"]),
        )
    cls = _NODE_TYPES[t]
    return cls(**{n: _load_node(s, base, device)
                  for n, s in spec["fields"].items()})


def save_packed_params(params: ModelParams, path, key: dict) -> None:
    """Write the packed parameters to `path` (a .torchpack directory).

    The manifest is removed first and written (atomically) last: an
    interrupted write leaves a directory without a manifest, which loads
    ignore, never an old manifest over partly rewritten arrays."""
    base = Path(path)
    base.mkdir(parents=True, exist_ok=True)
    (base / "manifest.json").unlink(missing_ok=True)
    arrays: list = []
    tree = _save_node(params, arrays, [0])
    for fname, a in arrays:
        np.save(base / fname, a)
    manifest = {"version": VERSION, "key": key, "tree": tree}
    tmp = base / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest))
    tmp.replace(base / "manifest.json")


def load_packed_params(path, expected_key: dict,
                       device="cpu") -> Optional[ModelParams]:
    """The cached parameters on `device` if the cache is present and its
    key matches; None otherwise. Each leaf is read from disk and copied
    to the device in turn."""
    base = Path(path)
    try:
        manifest = json.loads((base / "manifest.json").read_text())
        if manifest.get("version") != VERSION:
            return None
        if manifest.get("key") != expected_key:
            return None
        return _load_node(manifest["tree"], base, device)
    except (OSError, ValueError, KeyError, TypeError):
        # a malformed cache (unreadable, bad JSON, a tree of the wrong
        # structure, missing arrays) falls back to the transcode
        return None
