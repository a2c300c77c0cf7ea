"""Serving-engine checkpoint/resume: pause a continuous-batching engine
mid-flight and restore it, KV state and all, in a new process.

The counterpart of `llm_tpu/engine_snapshot.py` (its single-host parts).
The whole Engine / PagedEngine / speculative engine round-trips through
one file: the page pool or dense slot cache, the page tables, the
allocator's free list, the prefix cache with its exact-hit logits rows,
every in-flight stream's tokens, sampler state (mirostat mu included),
host RNG, UTF-8 buffer and chunked-prefill cursor, and the pending queue;
for the speculative engines also the draft's dense cache, `k` and the
acceptance counters. Draining is not required: a stream checkpointed
halfway through its prompt resumes at the same chunk boundary.

Byte format: the reference's. MAGIC, VERSION, a codec byte (1 zstd, 0
zlib), the JSON header's length and the header, then the arrays' raw
bytes, one after another in name order, in one compressed stream. A bf16
array is stored as its 16-bit words under the dtype name "bfloat16", as
the reference's numpy view of a bf16 array stores it. So a file of an
engine with no device-loop RNG state restores in either package.

The device loop's RNG is the engine's `torch.Generator` (`_loop_gen`,
which `step_multi` and the sampled speculative engines draw from); its
state is stored under the header key "torch_loop_gen". The reference's
JAX PRNG keys (`loop_key`, `speculative.key`) have no torch counterpart: a
file that carries one is refused with a SnapshotError that names the key,
rather than restored with other random draws.

Callbacks (`GenerationRequest.on_token`) are process-local and are not
serialized; `read_engine(..., on_token=...)` re-attaches one.

Multi-host engines (MultiHostEngine / MultiHostPagedEngine) checkpoint
one file a rank: every rank calls `write_engine` with its own path (the
server adds `.host<N>`), with no collective. A rank's file holds its
tensors as they are, which are already its block: its `data` block of
the slots (dense) or its whole row-local pool (paged), over its own kv
heads, with its streams, tables and allocator. The JAX package assembles
a host's block from the addressable shards of a global array and builds
the global array back on restore (`_local_block`, `_make_global`); the
port has no global arrays, so neither has a counterpart here. The header's
`multihost` record holds the JAX package's `process_index`,
`process_count`, `row0`, `global_streams` and `steps`, and the rank's
mesh coordinates `data_index` and `model_index` with the `model` width
`model_parallel`. A restore runs on the same layout: a file of another
layout is refused, naming both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from llm_tpu_torch.session import SnapshotError

MAGIC = b"LTEN"
VERSION = 1
LOOP_GEN_KEY = "torch_loop_gen"

# the dtype names of the file (numpy's, as the reference writes them)
_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
}
_NAMES = {t: n for n, t in _DTYPES.items()}


def _decompress(data: bytes, codec: str) -> bytes:
    """Streaming-frame decompress (the writer's zstd frames carry no
    content size, so a one-shot decompressor cannot read them)."""
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompressobj().decompress(data)
    return zlib.decompress(data)


# ---------------------------------------------------------------------------
# arrays: torch tensors (KV) and numpy arrays (logits rows) by file dtype


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return _NAMES[a.dtype]
    return str(a.dtype)


def _host_bytes(a) -> np.ndarray:
    """The array's bytes as a flat uint8 numpy array (bf16: its words)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _f32_row(row) -> np.ndarray:
    if isinstance(row, torch.Tensor):
        return row.detach().to("cpu", torch.float32).numpy()
    return np.asarray(row, np.float32)


# ---------------------------------------------------------------------------
# sampler (de)serialization: the built-in samplers are flat dataclasses
# (mirostat's mu included), so a name and a field dict round-trip them;
# any other class is refused


def _sampler_spec(s) -> Optional[dict]:
    import llm_tpu_torch.samplers as S
    from llm_tpu_torch.ops.sampling import BatchedDeviceSampler, DeviceSampler

    if s is None:
        return None
    if isinstance(s, S.SamplerChain):
        return {
            "kind": "chain",
            "transforms": [_sampler_spec(t) for t in s.transforms],
            "terminal": _sampler_spec(s.terminal),
        }
    if isinstance(s, (S.GreedySampler, S.DeterministicSampler)):
        return {"kind": "host", "cls": type(s).__name__, "kw": {}}
    if isinstance(s, DeviceSampler):
        return {"kind": "device", "kw": dataclasses.asdict(s)}
    if isinstance(s, BatchedDeviceSampler):
        raise SnapshotError(
            "BatchedDeviceSampler is derived per-dispatch; checkpoint the "
            "per-stream DeviceSamplers instead"
        )
    # identity, not name: a user dataclass that shadows a built-in's name
    # must be refused, not restored as the built-in
    if dataclasses.is_dataclass(s) and type(s) is getattr(
        S, type(s).__name__, None
    ):
        return {"kind": "host", "cls": type(s).__name__,
                "kw": dataclasses.asdict(s)}
    raise SnapshotError(
        f"sampler {type(s).__name__} is not checkpointable (not a built-in "
        "sampler dataclass); retire the stream or swap its sampler first"
    )


def _sampler_from(spec: Optional[dict]):
    import llm_tpu_torch.samplers as S
    from llm_tpu_torch.ops.sampling import DeviceSampler

    if spec is None:
        return None
    if spec["kind"] == "chain":
        return S.SamplerChain(
            [_sampler_from(t) for t in spec["transforms"]],
            _sampler_from(spec["terminal"]),
        )
    if spec["kind"] == "device":
        kw = dict(spec["kw"])
        kw["bias"] = tuple((int(t), float(b)) for t, b in kw.get("bias", ()))
        if "top_a" in kw:  # JSON gives a list; the dataclass hashes a tuple
            kw["top_a"] = tuple(float(a) for a in kw["top_a"])
        return DeviceSampler(**kw)
    cls = getattr(S, spec["cls"])
    return cls(**spec["kw"])


# ---------------------------------------------------------------------------
# streams


def _dump_prompt(p):
    from llm_tpu_torch.tokenizer import Prompt

    if isinstance(p, str):
        return {"text": p}
    if isinstance(p, Prompt):
        return {"text": p.text} if p.text is not None else {
            "tokens": [int(t) for t in (p.tokens or [])]
        }
    return {"tokens": [int(t) for t in p]}


def _load_prompt(d):
    return d["text"] if "text" in d else d["tokens"]


def _dump_stream(s, slot: Optional[int], arrays: dict) -> dict:
    req = s.request
    d = {
        "slot": slot,
        "request_id": s.request_id,
        "prompt": _dump_prompt(req.prompt),
        "max_tokens": req.max_tokens,
        "seed": req.seed,
        "logprobs": req.logprobs,
        "sampler": _sampler_spec(s.sampler),
        "device_sampler": _sampler_spec(req.device_sampler),
        "rng": s.rng.bit_generator.state,
        "tokens": [int(t) for t in s.tokens],
        "generated": s.generated,
        "n_past": s.n_past,
        "utf8": s.utf8.buffer.hex(),
        "decoded_len": s.decoded_len,
        "text": list(s.text),
        "logprob_data": s.logprob_data,
        "prefilling": s.prefilling,
        "prefill_pos": s.prefill_pos,
        "prefill_queue": (
            [int(t) for t in s.prefill_queue]
            if s.prefill_queue is not None
            else None
        ),
        "kv_wait": s.kv_wait,
        # the device mirostat's mu: the one part of a device sampler's
        # state the token history does not give
        "mirostat_mu": s.mirostat_mu,
    }
    if s.last_logits is not None:
        arrays[f"stream{s.request_id}.last_logits"] = _f32_row(s.last_logits)
        d["has_logits"] = True
    return d


def _load_stream(d: dict, arrays: dict, on_token):
    from llm_tpu_torch.serve import GenerationRequest, _Stream
    from llm_tpu_torch.tokenizer import TokenUtf8Buffer

    req = GenerationRequest(
        prompt=_load_prompt(d["prompt"]),
        max_tokens=d["max_tokens"],
        sampler=None,  # the live (possibly stateful) copy is the stream's
        seed=d["seed"],
        on_token=on_token,
        device_sampler=_sampler_from(d["device_sampler"]),
        logprobs=d["logprobs"],
    )
    rng = np.random.default_rng(d["seed"])
    rng.bit_generator.state = d["rng"]
    s = _Stream(
        request_id=d["request_id"],
        request=req,
        sampler=_sampler_from(d["sampler"]),
        rng=rng,
        tokens=list(d["tokens"]),
        generated=d["generated"],
        n_past=d["n_past"],
        last_logits=(
            arrays[f"stream{d['request_id']}.last_logits"].copy()
            if d.get("has_logits")
            else None
        ),
        utf8=TokenUtf8Buffer(bytearray(bytes.fromhex(d["utf8"]))),
        decoded_len=d["decoded_len"],
        text=list(d["text"]),
        logprob_data=list(d["logprob_data"]),
        prefilling=d["prefilling"],
        prefill_pos=d["prefill_pos"],
        prefill_queue=(
            list(d["prefill_queue"]) if d["prefill_queue"] is not None else None
        ),
        kv_wait=d["kv_wait"],
        mirostat_mu=d.get("mirostat_mu"),
    )
    req.sampler = s.sampler
    return s


# ---------------------------------------------------------------------------
# engines


def _is_mh(engine) -> bool:
    from llm_tpu_torch.parallel.multihost import MultiHostEngine

    return isinstance(engine, MultiHostEngine)


def _is_mh_paged(engine) -> bool:
    from llm_tpu_torch.parallel.multihost import MultiHostPagedEngine

    return isinstance(engine, MultiHostPagedEngine)


def _is_paged(engine) -> bool:
    from llm_tpu_torch.paged import PagedEngine

    return isinstance(engine, PagedEngine) or _is_mh_paged(engine)


def _mh_layout(engine) -> dict:
    """A multi-host rank's place: the layout a restore must match."""
    import torch.distributed as dist

    mesh = engine.mesh
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "row0": engine._row0,
        "global_streams": engine.global_streams,
        "data_index": mesh.coords["data"],
        "model_index": mesh.coords["model"],
        "model_parallel": mesh.shape["model"],
    }


def _kv_tensors(engine) -> dict:
    """The engine's KV tensors by file name (the restore copies into them)."""
    out = {}
    if _is_paged(engine):
        pool = engine.pool
        out["pool.k"], out["pool.v"] = pool.k, pool.v
        if pool.quantized:
            out["pool.k_scale"], out["pool.v_scale"] = (
                pool.k_scale, pool.v_scale,
            )
    else:
        c = engine.cache
        out["cache.k"], out["cache.v"] = c.k, c.v
        if c.k_scale is not None:
            out["cache.k_scale"], out["cache.v_scale"] = c.k_scale, c.v_scale
    d = getattr(engine, "d_cache", None)  # speculative engines: draft KV
    if d is not None:
        out["d_cache.k"], out["d_cache.v"] = d.k, d.v
        if d.k_scale is not None:
            out["d_cache.k_scale"], out["d_cache.v_scale"] = (
                d.k_scale, d.v_scale,
            )
    return out


def _spec_fingerprint(spec) -> dict:
    return {
        "arch": spec.arch,
        "n_vocab": spec.n_vocab,
        "n_embd": spec.n_embd,
        "n_head": spec.n_head,
        "n_head_kv": spec.n_head_kv,
        "n_layer": spec.n_layer,
        "n_ctx": spec.n_ctx,
    }


_SPEC_ENGINES = (
    "SpeculativeEngine", "SampledSpeculativeEngine",
    "PagedSpeculativeEngine", "PagedSampledSpeculativeEngine",
)


def _engine_kind(engine) -> str:
    from llm_tpu_torch.paged import PagedEngine

    if type(engine).__name__ in _SPEC_ENGINES:
        return type(engine).__name__
    if _is_mh_paged(engine):
        return "MultiHostPagedEngine"
    if _is_mh(engine):
        return "MultiHostEngine"
    if isinstance(engine, PagedEngine):
        return "PagedEngine"
    return "Engine"


def _loop_gen_state(engine) -> Optional[dict]:
    gen = getattr(engine, "_loop_gen", None)
    if gen is None:
        return None
    return {"device": gen.device.type,
            "state": gen.get_state().numpy().tobytes().hex()}


def write_engine(engine, path: str | Path) -> None:
    """Checkpoint a quiesced engine: call between step()s, on the thread
    that steps it. The file is written beside `path` and renamed over it,
    so a failed write leaves an earlier checkpoint as it was. A
    multi-host rank writes its own file (no collective)."""
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.serve import Engine

    if not isinstance(engine, (Engine, PagedEngine)):
        raise SnapshotError(f"cannot checkpoint {type(engine).__name__}")
    if engine._retired_events:
        raise SnapshotError(
            "undrained retirement events; finish the current step first"
        )

    arrays = dict(_kv_tensors(engine))
    streams = []
    for slot, s in enumerate(engine.slots):
        if s is not None:
            streams.append(_dump_stream(s, slot, arrays))
    for s in engine.pending:
        streams.append(_dump_stream(s, None, arrays))

    header = {
        "engine": _engine_kind(engine),
        "spec": _spec_fingerprint(engine.spec),
        "max_streams": engine.max_streams,
        "n_batch": engine.n_batch,
        "next_id": engine._next_id,
        "streams": streams,
    }
    gen = _loop_gen_state(engine)
    if gen is not None:
        header[LOOP_GEN_KEY] = gen
    if hasattr(engine, "d_cache"):  # speculative family
        header["speculative"] = {
            "k": engine.k,
            "draft_spec": _spec_fingerprint(engine.draft.spec),
            "accepted": engine.accepted,
            "drafted": engine.drafted,
        }
    if _is_mh(engine):
        header["multihost"] = dict(_mh_layout(engine), steps=engine._steps)
    if _is_paged(engine):
        pc = engine.prefix_cache
        header["paged"] = {
            "page_size": engine.page_size,
            "n_pages": engine.pool.n_pages,
            "tables": np.asarray(engine.tables).tolist(),
            "stream_pages": [
                [int(p) for p in pages] for pages in engine.stream_pages
            ],
            "free": [int(p) for p in engine.allocator.free],
            "prefix": (
                {
                    "by_key": [
                        [k.hex(), int(pid)] for k, pid in pc.by_key.items()
                    ],
                    "refs": {str(pid): n for pid, n in pc.refs.items()},
                    "lru": [int(p) for p in pc.lru],
                    # exact-hit logits rows ride the payload; the list's
                    # order is the LRU order
                    "logits_keys": [k.hex() for k in pc.logits_by_key],
                }
                if pc is not None
                else None
            ),
        }
        if pc is not None:
            for k, row in pc.logits_by_key.items():
                arrays[f"prefix_logits.{k.hex()}"] = _f32_row(row)

    names = sorted(arrays)
    header["arrays"] = [
        {"name": n, "dtype": _dtype_name(arrays[n]),
         "shape": list(arrays[n].shape)}
        for n in names
    ]
    hb = json.dumps(header).encode()

    # one array at a time through the compressor: the peak host memory is
    # one array, not the whole pool twice
    try:
        import zstandard

        comp = zstandard.ZstdCompressor(level=1).compressobj()
        codec_byte = 1
    except ImportError:
        comp = zlib.compressobj(1)
        codec_byte = 0
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", VERSION))
            f.write(struct.pack("<B", codec_byte))
            f.write(struct.pack("<I", len(hb)))
            f.write(hb)
            for n in names:
                out = comp.compress(_host_bytes(arrays[n]).data)
                if out:
                    f.write(out)
            f.write(comp.flush())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_engine(
    engine,
    path: str | Path,
    on_token: Optional[Callable[[int, str], None]] = None,
) -> None:
    """Restore a checkpoint into a freshly constructed compatible engine
    (the same model geometry, engine class and max_streams; for a paged
    one the same page size and page count). `on_token` is re-attached to
    every restored stream.

    Every malformed file is a SnapshotError, and a refused restore leaves
    the engine as it was: everything is read and checked before the
    engine is touched."""
    prepare_engine(engine, path, on_token)()


def prepare_engine(
    engine,
    path: str | Path,
    on_token: Optional[Callable[[int, str], None]] = None,
) -> Callable[[], None]:
    """The first half of `read_engine`: read and check the file against
    the engine without touching it, and return the commit that restores
    it. A SnapshotError here leaves the engine as constructed. The ranks
    of a multi-host world prepare their own files, agree, and then all
    commit or none does (`server.LlmServer`)."""
    try:
        return _prepare_engine(engine, path, on_token)
    except SnapshotError:
        raise
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise SnapshotError(
            f"malformed engine checkpoint {path}: "
            f"{type(e).__name__}: {e}"
        ) from e


def _prepare_engine(engine, path, on_token) -> Callable[[], None]:
    try:
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                raise SnapshotError(f"{path} is not an engine checkpoint")
            (version,) = struct.unpack("<I", f.read(4))
            if version != VERSION:
                raise SnapshotError(
                    f"unsupported engine checkpoint v{version}"
                )
            (codec_byte,) = struct.unpack("<B", f.read(1))
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            # a bytearray: the arrays are views of it, and writable
            payload = bytearray(
                _decompress(f.read(), "zstd" if codec_byte else "zlib"))
    except SnapshotError:
        raise
    except Exception as e:  # truncated or corrupt: struct, json, zstd and
        # zlib errors all mean the same to the caller
        raise SnapshotError(f"corrupt engine checkpoint {path}: {e}") from e

    if "loop_key" in header:
        raise SnapshotError(
            "checkpoint carries the reference's device-loop PRNG key "
            "'loop_key', which has no torch counterpart; refusing to "
            "restore it with other random draws"
        )
    if "key" in header.get("speculative", {}):
        raise SnapshotError(
            "checkpoint carries the reference's speculative PRNG key "
            "'speculative.key', which has no torch counterpart; refusing "
            "to restore it with other random draws"
        )
    want_cls = header["engine"]
    is_paged = _is_paged(engine)
    if _engine_kind(engine) != want_cls:
        raise SnapshotError(
            f"checkpoint is for {want_cls}, got {type(engine).__name__}"
        )
    if _is_mh(engine):
        got = _mh_layout(engine)
        want = {k: header["multihost"].get(k) for k in got}
        if got != want:
            raise SnapshotError(
                f"process layout mismatch: checkpoint {want}, engine {got}"
            )
    if _spec_fingerprint(engine.spec) != header["spec"]:
        raise SnapshotError(
            f"model geometry mismatch: checkpoint {header['spec']}, "
            f"engine {_spec_fingerprint(engine.spec)}"
        )
    if engine.max_streams != header["max_streams"]:
        raise SnapshotError(
            f"max_streams mismatch: checkpoint {header['max_streams']}, "
            f"engine {engine.max_streams}"
        )

    arrays = {}
    off = 0
    for meta in header["arrays"]:
        name, dname = meta["name"], meta["dtype"]
        if dname not in _DTYPES:
            raise SnapshotError(f"{name}: unsupported dtype {dname}")
        count = int(np.prod(meta["shape"], dtype=np.int64))
        nbytes = count * _DTYPES[dname].itemsize
        if off + nbytes > len(payload):
            raise SnapshotError(f"{name}: payload is truncated")
        raw = np.frombuffer(payload, np.uint8, count=nbytes, offset=off)
        off += nbytes
        if dname == "bfloat16":
            t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            arrays[name] = t.reshape(meta["shape"])
        else:
            arrays[name] = raw.view(np.dtype(dname)).reshape(meta["shape"])

    targets = _kv_tensors(engine)

    def kv(name: str) -> torch.Tensor:
        """A KV array of the file, checked against the engine's tensor."""
        if name not in arrays:
            raise SnapshotError(f"{name}: missing from the checkpoint")
        a, target = arrays[name], targets[name]
        got = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        if tuple(got.shape) != tuple(target.shape) or \
                got.dtype != target.dtype:
            raise SnapshotError(
                f"{name}: checkpoint {_dtype_name(a)}{list(a.shape)} does "
                f"not match engine {_NAMES.get(target.dtype, target.dtype)}"
                f"{list(target.shape)}"
            )
        return got

    # ---- phase 1: check everything and build the new state without
    # touching the engine, so a SnapshotError leaves it as constructed
    new: dict = {}
    gen_state = header.get(LOOP_GEN_KEY)
    if gen_state is not None:
        if gen_state["device"] != engine.device.type:
            raise SnapshotError(
                f"{LOOP_GEN_KEY}: a {gen_state['device']} generator's state "
                f"cannot restore into an engine on {engine.device.type}"
            )
        new["_loop_gen"] = torch.tensor(
            list(bytes.fromhex(gen_state["state"])), dtype=torch.uint8)

    if "speculative" in header:
        sp = header["speculative"]
        if sp["draft_spec"] != _spec_fingerprint(engine.draft.spec):
            raise SnapshotError(
                f"draft geometry mismatch: checkpoint {sp['draft_spec']}, "
                f"engine {_spec_fingerprint(engine.draft.spec)}"
            )
        if sp["k"] != engine.k:
            raise SnapshotError(
                f"draft k mismatch: checkpoint {sp['k']}, engine {engine.k}"
            )
        quant = "d_cache.k_scale" in arrays
        if quant != (engine.d_cache.k_scale is not None):
            raise SnapshotError("draft KV dtype mismatch")
        new["accepted"] = sp["accepted"]
        new["drafted"] = sp["drafted"]

    prefix_state = None
    if is_paged:
        p = header["paged"]
        if (engine.page_size, engine.pool.n_pages) != (
            p["page_size"], p["n_pages"],
        ):
            raise SnapshotError(
                f"page geometry mismatch: checkpoint "
                f"{p['page_size']}x{p['n_pages']}, engine "
                f"{engine.page_size}x{engine.pool.n_pages}"
            )
        quant = "pool.k_scale" in arrays
        if quant != engine.pool.quantized:
            raise SnapshotError("KV dtype mismatch (int8 vs dense pool)")
        if p["prefix"] is not None and engine.prefix_cache is None:
            raise SnapshotError(
                "checkpoint has a prefix cache; construct the engine "
                "with prefix_cache=True"
            )
        tables = np.asarray(p["tables"], np.int32)
        if tables.shape != np.asarray(engine.tables).shape:
            raise SnapshotError(
                f"page tables {list(tables.shape)} do not match the "
                f"engine's {list(np.asarray(engine.tables).shape)}"
            )
        new["tables"] = tables.astype(np.asarray(engine.tables).dtype)
        new["stream_pages"] = [list(x) for x in p["stream_pages"]]
        if p["prefix"] is not None:
            prefix_state = {
                "by_key": {
                    bytes.fromhex(k): pid for k, pid in p["prefix"]["by_key"]
                },
                "refs": {
                    int(pid): n for pid, n in p["prefix"]["refs"].items()
                },
                "lru": {int(pid): None for pid in p["prefix"]["lru"]},
                # the list's order restores the LRU order
                "logits": {
                    bytes.fromhex(k): arrays[f"prefix_logits.{k}"].copy()
                    for k in p["prefix"].get("logits_keys", ())
                },
            }
    else:
        quant = "cache.k_scale" in arrays
        if quant != (engine.cache.k_scale is not None):
            raise SnapshotError("KV dtype mismatch (int8 vs dense cache)")
    kv_new = {name: kv(name) for name in targets}

    slots = [None] * engine.max_streams
    pending = []
    for d in header["streams"]:
        s = _load_stream(d, arrays, on_token)
        if d["slot"] is None:
            pending.append(s)
        else:
            slots[d["slot"]] = s

    # ---- phase 2: commit. KV goes into the engine's own tensors, so the
    # CUDA graphs captured over them stay valid.
    def commit() -> None:
        for name, src in kv_new.items():
            targets[name].copy_(src)
        if "_loop_gen" in new:
            gen = torch.Generator(device=engine.device)
            gen.set_state(new.pop("_loop_gen"))
            engine._loop_gen = gen
        else:
            # a fresh chain from seed 0, as constructed
            engine._loop_gen = None
        for attr, val in new.items():
            setattr(engine, attr, val)
        if _is_mh(engine):
            engine._steps = int(header["multihost"]["steps"])
        if is_paged:
            engine.allocator.free = list(header["paged"]["free"])
            if prefix_state is not None:
                pc = engine.prefix_cache
                pc.by_key = prefix_state["by_key"]
                pc.key_of = {pid: k for k, pid in pc.by_key.items()}
                pc.refs = prefix_state["refs"]
                pc.lru = prefix_state["lru"]
                pc.logits_by_key = prefix_state["logits"]
            elif engine.prefix_cache is not None:
                # the checkpoint has no prefix state: leave nothing stale
                engine.prefix_cache = type(engine.prefix_cache)()

        engine.slots = slots
        engine.pending = pending
        engine.finished = {}
        engine._retired_events = []
        engine._next_id = header["next_id"]

    return commit
