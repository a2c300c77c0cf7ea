"""Session snapshot persistence for the CLI: the counterpart of
`llm_tpu/snapshot.py`, in its byte format, so that a session written by
either package loads in the other.

The reference serializes InferenceSnapshot with bincode + zstd level 1
(llm/binaries/llm-cli/src/snapshot.rs:15,47-62). Here the
container is a compressed npz-style pickle-free format: header JSON +
raw KV bytes, compressed with zstandard when available (zlib otherwise).
read_or_create_session keeps the reference precedence: persist > load > new.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from llm_tpu_torch.session import (
    InferenceSession,
    InferenceSessionConfig,
    InferenceSnapshot,
    ModelKVMemoryType,
    SnapshotError,
)

MAGIC = b"LTSN"
VERSION = 2


def _compress(data: bytes) -> tuple[bytes, str]:
    try:
        import zstandard

        return zstandard.ZstdCompressor(level=1).compress(data), "zstd"
    except ImportError:
        return zlib.compress(data, 1), "zlib"


def _decompress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


def write_session(session: InferenceSession, path: str | Path) -> None:
    snap = session.get_snapshot()
    last_logits = np.asarray(snap.last_logits, np.float32).tobytes()
    header = {
        "npast": snap.npast,
        "tokens": snap.tokens,
        # v2: last_logits rides the binary blob (v1 stored ~600 KB of
        # decimal JSON text per save)
        "ll_len": len(last_logits),
        "k_shape": list(snap.k_shape),
        "v_shape": list(snap.v_shape),
        "k_dtype": snap.k_dtype,
        "v_dtype": snap.v_dtype,
        "memory_k_type": snap.config.memory_k_type.value,
        "memory_v_type": snap.config.memory_v_type.value,
        "n_batch": snap.config.n_batch,
        "n_threads": snap.config.n_threads,
        "k_len": len(snap.memory_k),
        "v_len": len(snap.memory_v),
        "scale_shape": list(snap.scale_shape) if snap.scale_shape else None,
        "ks_len": len(snap.memory_k_scale) if snap.memory_k_scale else 0,
    }
    hb = json.dumps(header).encode()
    blob = last_logits + snap.memory_k + snap.memory_v
    if snap.memory_k_scale:
        blob += snap.memory_k_scale + snap.memory_v_scale
    payload, codec = _compress(blob)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<B", 1 if codec == "zstd" else 0))
        f.write(struct.pack("<I", len(hb)))
        f.write(hb)
        f.write(payload)


def read_session(model, path: str | Path) -> InferenceSession:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise SnapshotError(f"{path} is not a session snapshot")
        (version,) = struct.unpack("<I", f.read(4))
        if version not in (1, VERSION):  # v1 read-compat: JSON logits
            raise SnapshotError(f"unsupported snapshot version {version}")
        (codec_byte,) = struct.unpack("<B", f.read(1))
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        payload = _decompress(f.read(), "zstd" if codec_byte else "zlib")

    config = InferenceSessionConfig(
        memory_k_type=ModelKVMemoryType(header["memory_k_type"]),
        memory_v_type=ModelKVMemoryType(header["memory_v_type"]),
        n_batch=header["n_batch"],
        n_threads=header["n_threads"],
    )
    ll_len = header.get("ll_len", 0)  # 0: v1 header-JSON logits
    last_logits = (
        np.frombuffer(payload[:ll_len], np.float32).copy()
        if ll_len
        else np.asarray(header["last_logits"], np.float32)
    )
    payload = payload[ll_len:]
    k_len = header["k_len"]
    v_len = header.get("v_len", len(payload) - k_len)
    ks_len = header.get("ks_len", 0)
    kv_end = k_len + v_len
    snap = InferenceSnapshot(
        npast=header["npast"],
        config=config,
        tokens=header["tokens"],
        last_logits=last_logits,
        memory_k=payload[:k_len],
        memory_v=payload[k_len:kv_end],
        k_shape=tuple(header["k_shape"]),
        v_shape=tuple(header["v_shape"]),
        k_dtype=header["k_dtype"],
        v_dtype=header["v_dtype"],
        memory_k_scale=(
            payload[kv_end : kv_end + ks_len] if ks_len else None
        ),
        memory_v_scale=(payload[kv_end + ks_len :] if ks_len else None),
        scale_shape=(
            tuple(header["scale_shape"]) if header.get("scale_shape") else None
        ),
    )
    return InferenceSession.from_snapshot(snap, model)


def read_or_create_session(
    model,
    persist_session: Optional[Path],
    load_session: Optional[Path],
    config: InferenceSessionConfig,
) -> Tuple[InferenceSession, bool]:
    """Precedence: persist (if it exists) > load > new (snapshot.rs:39-43)."""
    if persist_session is not None and Path(persist_session).exists():
        return read_session(model, persist_session), True
    if load_session is not None:
        return read_session(model, load_session), True
    return InferenceSession(model, config), False
