"""GGUF v2/v3 container support (the GGML successor format).

Out of the reference's scope (rustformers/llm predates GGUF) but most real
checkpoints now ship as GGUF, so the loader accepts it: `GgufReader` parses
the metadata KV store and tensor index and presents the SAME surface as
`GgmlReader` (container/vocabulary/tensors/hyperparameters/fetch), with
GGUF tensor names translated to the classic GGML names at index time so the
spec-driven parameter builder works unchanged.

Format (little-endian):
    magic "GGUF" | u32 version (2|3) | u64 n_tensors | u64 n_kv
    n_kv x { string key | u32 type | value }      (types below)
    n_tensors x { string name | u32 n_dims | u64 dims[n_dims]
                  | u32 ggml_type | u64 offset }  (offset is relative to
                                                   the aligned data start)
    pad to `general.alignment` (default 32) | tensor data

Value types: 0 u8, 1 i8, 2 u16, 3 i16, 4 u32, 5 i32, 6 f32, 7 bool,
8 string (u64 len + bytes), 9 array (u32 elem type + u64 count + elems),
10 u64, 11 i64, 12 f64. GGUF v1 (u32 counts) is rejected.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, BinaryIO, Optional

import numpy as np

from llm_tpu_torch.ggml.reader import FormatError, TensorInfo, Vocabulary
from llm_tpu_torch.ggml.types import ContainerType, FileType, GgmlType
from llm_tpu_torch.ggml.writer import SaveError

GGUF_MAGIC = b"GGUF"

_SCALARS = {
    0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2),
    4: ("<I", 4), 5: ("<i", 4), 6: ("<f", 4), 7: ("<B", 1),
    10: ("<Q", 8), 11: ("<q", 8), 12: ("<d", 8),
}
_T_STRING = 8
_T_ARRAY = 9


def is_gguf(path) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == GGUF_MAGIC


def _read(f: BinaryIO, fmt: str, size: int):
    b = f.read(size)
    if len(b) != size:
        raise FormatError("unexpected end of GGUF file")
    return struct.unpack(fmt, b)[0]


def _remaining(f: BinaryIO) -> int:
    pos = f.tell()
    end = f.seek(0, 2)
    f.seek(pos)
    return end - pos


def _check_count(f: BinaryIO, n: int, unit: int, what: str) -> int:
    """Counts and lengths come from the (untrusted) file: bound them by
    the bytes actually present so a corrupt/hostile header can neither
    allocation-bomb the process (MemoryError on f.read(2**60)) nor spin a
    near-infinite parse loop — it fails as a clean FormatError instead."""
    if n < 0 or unit and n > _remaining(f) // unit:
        raise FormatError(
            f"GGUF {what} count {n} exceeds the bytes present in the file"
        )
    return n


def _read_string(f: BinaryIO) -> bytes:
    n = _check_count(f, _read(f, "<Q", 8), 1, "string length")
    b = f.read(n)
    if len(b) != n:
        raise FormatError("unexpected end of GGUF string")
    return b


def _read_value(f: BinaryIO, t: int) -> Any:
    if t in _SCALARS:
        fmt, size = _SCALARS[t]
        v = _read(f, fmt, size)
        return bool(v) if t == 7 else v
    if t == _T_STRING:
        return _read_string(f)
    if t == _T_ARRAY:
        et = _read(f, "<I", 4)
        n = _read(f, "<Q", 8)
        if et in _SCALARS:
            fmt, size = _SCALARS[et]
            _check_count(f, n, size, "array")
            raw = f.read(n * size)
            if len(raw) != n * size:
                raise FormatError("unexpected end of GGUF array")
            vals = list(struct.unpack(f"<{n}{fmt[-1]}", raw))
            return [bool(v) for v in vals] if et == 7 else vals
        if et == _T_STRING:
            _check_count(f, n, 8, "string array")
            return [_read_string(f) for _ in range(n)]
        raise FormatError(f"unsupported GGUF array element type {et}")
    raise FormatError(f"unsupported GGUF value type {t}")


# GGUF -> classic GGML tensor names, per architecture (the gguf.md naming
# convention: token_embd / output_norm / blk.N.attn_* ...). Layer index
# rides the {} placeholder. Unmapped names pass through unchanged.


def _blk(table: dict, layer_map: dict) -> dict:
    """Expand {gguf_suffix: ggml_pattern} pairs into blk.{}.* entries."""
    out = dict(table)
    for gguf_sfx, ggml_pat in layer_map.items():
        out[f"blk.{{}}.{gguf_sfx}"] = ggml_pat
    return out


_NAME_MAPS = {
    "llama": _blk(
        {
            "token_embd.weight": "tok_embeddings.weight",
            "output_norm.weight": "norm.weight",
            "output.weight": "output.weight",
        },
        {
            "attn_norm.weight": "layers.{}.attention_norm.weight",
            "attn_q.weight": "layers.{}.attention.wq.weight",
            "attn_k.weight": "layers.{}.attention.wk.weight",
            "attn_v.weight": "layers.{}.attention.wv.weight",
            "attn_output.weight": "layers.{}.attention.wo.weight",
            "ffn_norm.weight": "layers.{}.ffn_norm.weight",
            "ffn_gate.weight": "layers.{}.feed_forward.w1.weight",
            "ffn_down.weight": "layers.{}.feed_forward.w2.weight",
            "ffn_up.weight": "layers.{}.feed_forward.w3.weight",
        },
    ),
    "gpt2": _blk(
        {
            "token_embd.weight": "model/wte",
            "pos_embd.weight": "model/wpe",
            "output_norm.weight": "model/ln_f/g",
            "output_norm.bias": "model/ln_f/b",
            "output.weight": "model/lm_head",
        },
        {
            "attn_norm.weight": "model/h{}/ln_1/g",
            "attn_norm.bias": "model/h{}/ln_1/b",
            "attn_qkv.weight": "model/h{}/attn/c_attn/w",
            "attn_qkv.bias": "model/h{}/attn/c_attn/b",
            "attn_output.weight": "model/h{}/attn/c_proj/w",
            "attn_output.bias": "model/h{}/attn/c_proj/b",
            "ffn_norm.weight": "model/h{}/ln_2/g",
            "ffn_norm.bias": "model/h{}/ln_2/b",
            "ffn_up.weight": "model/h{}/mlp/c_fc/w",
            "ffn_up.bias": "model/h{}/mlp/c_fc/b",
            "ffn_down.weight": "model/h{}/mlp/c_proj/w",
            "ffn_down.bias": "model/h{}/mlp/c_proj/b",
        },
    ),
    "gptj": _blk(
        {
            "token_embd.weight": "transformer.wte.weight",
            "output_norm.weight": "transformer.ln_f.weight",
            "output_norm.bias": "transformer.ln_f.bias",
            "output.weight": "lm_head.weight",
            "output.bias": "lm_head.bias",
        },
        {
            "attn_norm.weight": "transformer.h.{}.ln_1.weight",
            "attn_norm.bias": "transformer.h.{}.ln_1.bias",
            "attn_q.weight": "transformer.h.{}.attn.q_proj.weight",
            "attn_k.weight": "transformer.h.{}.attn.k_proj.weight",
            "attn_v.weight": "transformer.h.{}.attn.v_proj.weight",
            "attn_output.weight": "transformer.h.{}.attn.out_proj.weight",
            "ffn_up.weight": "transformer.h.{}.mlp.fc_in.weight",
            "ffn_up.bias": "transformer.h.{}.mlp.fc_in.bias",
            "ffn_down.weight": "transformer.h.{}.mlp.fc_out.weight",
            "ffn_down.bias": "transformer.h.{}.mlp.fc_out.bias",
        },
    ),
    "gptneox": _blk(
        {
            "token_embd.weight": "gpt_neox.embed_in.weight",
            "output_norm.weight": "gpt_neox.final_layer_norm.weight",
            "output_norm.bias": "gpt_neox.final_layer_norm.bias",
            "output.weight": "embed_out.weight",
        },
        {
            "attn_norm.weight": "gpt_neox.layers.{}.input_layernorm.weight",
            "attn_norm.bias": "gpt_neox.layers.{}.input_layernorm.bias",
            "attn_qkv.weight": "gpt_neox.layers.{}.attention.query_key_value.weight",
            "attn_qkv.bias": "gpt_neox.layers.{}.attention.query_key_value.bias",
            "attn_output.weight": "gpt_neox.layers.{}.attention.dense.weight",
            "attn_output.bias": "gpt_neox.layers.{}.attention.dense.bias",
            "ffn_norm.weight": "gpt_neox.layers.{}.post_attention_layernorm.weight",
            "ffn_norm.bias": "gpt_neox.layers.{}.post_attention_layernorm.bias",
            "ffn_up.weight": "gpt_neox.layers.{}.mlp.dense_h_to_4h.weight",
            "ffn_up.bias": "gpt_neox.layers.{}.mlp.dense_h_to_4h.bias",
            "ffn_down.weight": "gpt_neox.layers.{}.mlp.dense_4h_to_h.weight",
            "ffn_down.bias": "gpt_neox.layers.{}.mlp.dense_4h_to_h.bias",
        },
    ),
    "bloom": _blk(
        {
            "token_embd.weight": "tok_embeddings.weight",
            "token_embd_norm.weight": "norm.weight",
            "token_embd_norm.bias": "norm.bias",
            "output_norm.weight": "output_norm.weight",
            "output_norm.bias": "output_norm.bias",
            "output.weight": "output.weight",
        },
        {
            "attn_norm.weight": "layers.{}.attention_norm.weight",
            "attn_norm.bias": "layers.{}.attention_norm.bias",
            "attn_qkv.weight": "layers.{}.attention.query_key_value.weight",
            "attn_qkv.bias": "layers.{}.attention.query_key_value.bias",
            "attn_output.weight": "layers.{}.attention.wo.weight",
            "attn_output.bias": "layers.{}.attention.wo.bias",
            "ffn_norm.weight": "layers.{}.ffn_norm.weight",
            "ffn_norm.bias": "layers.{}.ffn_norm.bias",
            "ffn_up.weight": "layers.{}.feed_forward.w1.weight",
            "ffn_up.bias": "layers.{}.feed_forward.w1.bias",
            "ffn_down.weight": "layers.{}.feed_forward.w2.weight",
            "ffn_down.bias": "layers.{}.feed_forward.w2.bias",
        },
    ),
    "mpt": _blk(
        {
            "token_embd.weight": "transformer.wte.weight",
            "output_norm.weight": "transformer.norm_f.weight",
        },
        {
            "attn_norm.weight": "transformer.blocks.{}.norm_1.weight",
            "attn_qkv.weight": "transformer.blocks.{}.attn.Wqkv.weight",
            "attn_output.weight": "transformer.blocks.{}.attn.out_proj.weight",
            "ffn_norm.weight": "transformer.blocks.{}.norm_2.weight",
            "ffn_up.weight": "transformer.blocks.{}.ffn.up_proj.weight",
            "ffn_down.weight": "transformer.blocks.{}.ffn.down_proj.weight",
        },
    ),
    "falcon": _blk(
        {
            "token_embd.weight": "transformer.word_embeddings.weight",
            "output_norm.weight": "transformer.ln_f.weight",
            "output_norm.bias": "transformer.ln_f.bias",
            "output.weight": "lm_head.weight",
        },
        {
            # 7B single shared LN; 40B ln_attn (attn_norm) + ln_mlp
            # (attn_norm_2) — the 7B file simply lacks attn_norm_2
            "attn_norm.weight": "transformer.h.{}.input_layernorm.weight",
            "attn_norm.bias": "transformer.h.{}.input_layernorm.bias",
            "attn_norm_2.weight": "transformer.h.{}.ln_mlp.weight",
            "attn_norm_2.bias": "transformer.h.{}.ln_mlp.bias",
            "attn_qkv.weight": "transformer.h.{}.self_attention.query_key_value.weight",
            "attn_output.weight": "transformer.h.{}.self_attention.dense.weight",
            "ffn_up.weight": "transformer.h.{}.mlp.dense_h_to_4h.weight",
            "ffn_down.weight": "transformer.h.{}.mlp.dense_4h_to_h.weight",
        },
    ),
}


def _name_table(arch: str, metadata: dict) -> dict:
    table = dict(_NAME_MAPS.get(arch, {}))
    if arch == "falcon":
        kv = int(metadata.get("falcon.attention.head_count_kv", 1) or 1)
        if kv > 1:  # 40B layout: dual norms ln_attn + ln_mlp
            table["blk.{}.attn_norm.weight"] = "transformer.h.{}.ln_attn.weight"
            table["blk.{}.attn_norm.bias"] = "transformer.h.{}.ln_attn.bias"
    return table


def _translate_name(table: dict, name: str) -> str:
    if name in table:
        return table[name]
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "blk" and parts[1].isdigit():
        pattern = f"blk.{{}}.{'.'.join(parts[2:])}"
        if pattern in table:
            return table[pattern].format(parts[1])
    return name


class GgufReader:
    """GGUF parser with the GgmlReader post-load surface."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.container: Optional[ContainerType] = None
        self.vocabulary = Vocabulary()
        self.tensors: dict[str, TensorInfo] = {}
        self.hyperparameters = None
        self.metadata: dict[str, Any] = {}
        self._mmap: Optional[np.ndarray] = None

    def load(self, architecture: Optional[str] = None) -> "GgufReader":
        with open(self.path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise FormatError("not a GGUF file")
            version = _read(f, "<I", 4)
            if version not in (2, 3):
                raise FormatError(
                    f"unsupported GGUF version {version} (v2/v3 only)"
                )
            self.container = ContainerType("gguf", version)
            n_tensors = _read(f, "<Q", 8)
            n_kv = _read(f, "<Q", 8)
            # a KV entry is >= 12 bytes, a tensor record >= 24: bound both
            # counts by the file so corrupt headers fail cleanly
            _check_count(f, n_kv, 12, "metadata")
            _check_count(f, n_tensors, 24, "tensor")

            for _ in range(n_kv):
                key = _read_string(f).decode("utf-8", errors="replace")
                t = _read(f, "<I", 4)
                self.metadata[key] = _read_value(f, t)

            arch = architecture or (
                self.metadata.get("general.architecture", b"llama").decode()
                if isinstance(self.metadata.get("general.architecture"), bytes)
                else self.metadata.get("general.architecture", "llama")
            )
            self.arch = arch

            infos = []
            for _ in range(n_tensors):
                name = _read_string(f).decode("utf-8", errors="replace")
                n_dims = _read(f, "<I", 4)
                if n_dims > 4:  # ggml tensors are at most 4-D
                    raise FormatError(
                        f"tensor {name!r} claims {n_dims} dimensions"
                    )
                dims = [int(_read(f, "<Q", 8)) for _ in range(n_dims)]
                ftype_raw = _read(f, "<I", 4)
                offset = _read(f, "<Q", 8)
                try:
                    element_type = GgmlType(ftype_raw)
                except ValueError:
                    raise FormatError(
                        f"unsupported tensor type {ftype_raw} for {name}"
                    ) from None
                infos.append((name, n_dims, dims, element_type, offset))

            align = int(self.metadata.get("general.alignment", 32))
            if align < 1:  # untrusted header: 0 would ZeroDivisionError,
                raise FormatError(  # negative would corrupt every offset
                    f"invalid general.alignment {align}"
                )
            data_start = (f.tell() + align - 1) // align * align

            table = _name_table(arch, self.metadata)
            self.source_names: dict[str, str] = {}
            for name, n_dims, dims, element_type, offset in infos:
                gname = _translate_name(table, name)
                self.source_names[gname] = name  # classic -> original GGUF
                self.tensors[gname] = TensorInfo(
                    name=gname,
                    n_dims=n_dims,
                    dims=tuple(dims) if dims else (1,),
                    element_type=element_type,
                    start_offset=data_start + offset,
                )

        self._build_vocab()
        self._build_hparams(arch)
        return self

    # -- metadata -> classic structures ----------------------------------

    def _build_vocab(self) -> None:
        toks = self.metadata.get("tokenizer.ggml.tokens")
        if not toks:
            return
        scores = self.metadata.get("tokenizer.ggml.scores") or [0.0] * len(toks)
        if len(scores) < len(toks):  # malformed: pad rather than truncate
            scores = list(scores) + [0.0] * (len(toks) - len(scores))
        for t, s in zip(toks, scores):
            self.vocabulary.tokens.append(
                t if isinstance(t, bytes) else str(t).encode()
            )
            self.vocabulary.scores.append(float(s))

    def _build_hparams(self, arch: str):
        from llm_tpu_torch.models.spec import Hyperparameters

        md = self.metadata

        def get(key: str, default=0):
            return md.get(f"{arch}.{key}", default)

        h = Hyperparameters(arch=arch)
        h.n_vocab = len(self.vocabulary.tokens) or int(get("vocab_size", 0))
        h.n_embd = int(get("embedding_length"))
        h.n_layer = int(get("block_count"))
        h.n_head = int(get("attention.head_count"))
        h.n_head_kv = int(get("attention.head_count_kv", h.n_head) or h.n_head)
        h.n_ctx = int(get("context_length"))
        h.max_seq_len = h.n_ctx
        h.n_rot = int(
            get("rope.dimension_count",
                h.n_embd // h.n_head if h.n_head else 0)
        )
        h.use_parallel_residual = bool(get("use_parallel_residual", True))
        # standard key first (llama.cpp: {arch}.attention.max_alibi_bias);
        # accept our earlier spelling for files we wrote before
        h.alibi_bias_max = float(
            get("attention.max_alibi_bias", 0.0)
            or get("attention.alibi_bias_max", 0.0)
        )
        h.n_mult = int(get("feed_forward_multiple", 256) or 256)
        # rope settings baked into the checkpoint (CodeLlama-style long-rope
        # files, linearly-scaled fine-tunes); CLI --rope-freq-* still wins
        fb = get("rope.freq_base", None)
        if fb:
            h.rope_freq_base = float(fb)
        # both spellings: pre-scaling-type key and the newer structured one;
        # a linear factor f stretches positions by f => frequency scale 1/f
        factor = get("rope.scale_linear", None) or get(
            "rope.scaling.factor", None
        )
        st = get("rope.scaling.type", "linear")
        if isinstance(st, bytes):  # GGUF strings decode to bytes
            st = st.decode("utf-8", errors="replace")
        if factor and float(factor) > 0 and st in ("linear", "", None):
            h.rope_freq_scale = 1.0 / float(factor)
        ft = md.get("general.file_type")
        if ft is not None:
            # GGUF file_type is the bare ftype enum (no QNT_VERSION_FACTOR);
            # GGUF always stores current-revision quant blocks
            h.file_type = FileType.from_i32(int(ft))
        quantized = any(
            t.element_type.is_quantized for t in self.tensors.values()
        )
        if quantized:
            h.file_type = FileType(
                format=h.file_type.format, quantization_version=2
            )
        self.hyperparameters = h

    # -- data access (same surface as GgmlReader) -------------------------

    def fetch(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        if self._mmap is None:
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
        end = info.start_offset + info.calc_size()
        if info.start_offset < 0 or end > self._mmap.size:
            # offsets come from the untrusted header; a memmap slice would
            # silently clamp at EOF and feed a SHORT buffer to the native
            # transcoder (out-of-bounds C reads)
            raise FormatError(
                f"tensor {name!r} data [{info.start_offset}, {end}) exceeds "
                f"file size {self._mmap.size}"
            )
        return self._mmap[info.start_offset : end]

    def fetch_f32(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        from llm_tpu_torch.ggml.quant import dequantize

        flat = dequantize(
            info.element_type, self.fetch(name), int(np.prod(info.dims))
        )
        return flat.reshape(tuple(reversed(info.dims)))


# ---------------------------------------------------------------------------
# writer (tests + conversion)


def _w_string(f: BinaryIO, s: bytes) -> None:
    f.write(struct.pack("<Q", len(s)))
    f.write(s)


def _w_value(f: BinaryIO, v: Any) -> None:
    if isinstance(v, bool):
        f.write(struct.pack("<I", 7))
        f.write(struct.pack("<B", int(v)))
    elif isinstance(v, int):
        f.write(struct.pack("<I", 4 if 0 <= v < 2**32 else 11))
        f.write(struct.pack("<I" if 0 <= v < 2**32 else "<q", v))
    elif isinstance(v, float):
        f.write(struct.pack("<I", 6))
        f.write(struct.pack("<f", v))
    elif isinstance(v, (bytes, str)):
        f.write(struct.pack("<I", _T_STRING))
        _w_string(f, v.encode() if isinstance(v, str) else v)
    elif isinstance(v, (list, tuple)):
        f.write(struct.pack("<I", _T_ARRAY))
        if not v or isinstance(v[0], (bytes, str)):
            f.write(struct.pack("<IQ", _T_STRING, len(v)))
            for s in v:
                _w_string(f, s.encode() if isinstance(s, str) else s)
        elif isinstance(v[0], float):
            f.write(struct.pack("<IQ", 6, len(v)))
            f.write(struct.pack(f"<{len(v)}f", *v))
        elif isinstance(v[0], int):
            f.write(struct.pack("<IQ", 5, len(v)))
            f.write(struct.pack(f"<{len(v)}i", *v))
        else:
            raise ValueError(f"unsupported array element {type(v[0])}")
    else:
        raise ValueError(f"unsupported metadata value {type(v)}")


class GgufWriter:
    """Minimal GGUF v3 writer (round-trip tests; GGML->GGUF conversion)."""

    ALIGN = 32

    def __init__(self, f: BinaryIO):
        self.f = f
        self._tensors: list[tuple[str, tuple, GgmlType, bytes]] = []
        self._metadata: dict[str, Any] = {}

    def add_metadata(self, key: str, value: Any) -> None:
        self._metadata[key] = value

    def add_tensor(
        self, name: str, t: GgmlType, dims: tuple, data: bytes
    ) -> None:
        self._tensors.append((name, tuple(dims), t, data))

    def finish(self) -> None:
        f = self.f
        f.write(GGUF_MAGIC)
        md = dict(self._metadata)
        md.setdefault("general.alignment", self.ALIGN)
        if int(md["general.alignment"]) != self.ALIGN:
            # offsets/padding below are computed with ALIGN; honoring a
            # different declared value would shift the whole data section
            # for any conforming reader
            raise SaveError(
                f"GgufWriter pads with alignment {self.ALIGN}; "
                f"general.alignment={md['general.alignment']} unsupported"
            )
        f.write(struct.pack("<IQQ", 3, len(self._tensors), len(md)))
        for k, v in md.items():
            _w_string(f, k.encode())
            _w_value(f, v)
        offset = 0
        for name, dims, t, data in self._tensors:
            _w_string(f, name.encode())
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", int(t), offset))
            offset += (len(data) + self.ALIGN - 1) // self.ALIGN * self.ALIGN
        pad = (-f.tell()) % self.ALIGN
        f.write(b"\x00" * pad)
        for _, _, _, data in self._tensors:
            f.write(data)
            f.write(b"\x00" * ((-len(data)) % self.ALIGN))


def gguf_name_fn(architecture: str, metadata: Optional[dict] = None):
    """classic GGML tensor name -> GGUF name translator for an arch.

    The ggml layer index is matched by regex (ggml names differ per arch:
    layers.N, model/hN, transformer.h.N, transformer.blocks.N,
    gpt_neox.layers.N); unmapped names pass through unchanged."""
    import re

    table = _name_table(architecture, metadata or {})
    reverse = {v: k for k, v in table.items()}
    rev_res = [
        (re.compile("^" + re.escape(pat).replace(r"\{\}", r"(\d+)") + "$"), g)
        for pat, g in reverse.items()
        if "{}" in pat
    ]

    def to_gguf_name(name: str) -> str:
        if name in reverse:
            return reverse[name]
        for rx, gguf_pat in rev_res:
            m = rx.match(name)
            if m:
                return gguf_pat.format(m.group(1))
        return name

    return to_gguf_name


def arch_metadata(
    architecture: str, h, vocabulary, n_ff: Optional[int] = None
) -> dict:
    """GGUF metadata block from classic hyperparameters + scored vocab."""
    md = {
        "general.architecture": architecture,
        f"{architecture}.embedding_length": h.n_embd,
        f"{architecture}.block_count": h.n_layer,
        f"{architecture}.attention.head_count": h.n_head,
        f"{architecture}.attention.head_count_kv": h.n_head_kv or h.n_head,
        f"{architecture}.rope.dimension_count": h.n_rot,
        f"{architecture}.context_length": h.n_ctx or h.max_seq_len or 2048,
        f"{architecture}.use_parallel_residual": bool(
            h.use_parallel_residual
        ),
        "general.file_type": int(h.file_type.format),
        # "llama" = scored sentencepiece-style vocab (what classic GGML
        # embeds); BPE-family checkpoints keep merges via the GGUF->GGUF
        # passthrough or an external tokenizer (tokenizer_json)
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": list(vocabulary.tokens),
        "tokenizer.ggml.scores": [float(s) for s in vocabulary.scores],
    }
    if h.alibi_bias_max:
        md[f"{architecture}.attention.max_alibi_bias"] = float(
            h.alibi_bias_max
        )
    if h.n_mult:
        md[f"{architecture}.feed_forward_multiple"] = int(h.n_mult)
    if n_ff:
        md[f"{architecture}.feed_forward_length"] = int(n_ff)
    if h.rope_freq_base:
        md[f"{architecture}.rope.freq_base"] = float(h.rope_freq_base)
    if h.rope_freq_scale and h.rope_freq_scale != 1.0:
        md[f"{architecture}.rope.scale_linear"] = 1.0 / float(
            h.rope_freq_scale
        )
    # bot/eot ids when the tokens exist in the vocab (KnownModel::
    # {bot,eot}_token_id analog; llama's </s> convention falls back to 2)
    from llm_tpu_torch.models.spec import get_arch

    try:
        info = get_arch(architecture)
    except Exception:  # noqa: BLE001
        info = None
    if info is not None:
        index = {t: i for i, t in enumerate(vocabulary.tokens)}
        if info.bot_token:
            bid = index.get(info.bot_token.encode())
            if bid is not None:
                md["tokenizer.ggml.bos_token_id"] = int(bid)
        eid = index.get(info.eot_token.encode())
        if eid is None:
            eid = info.eot_fallback_id
        if eid is not None:
            md["tokenizer.ggml.eos_token_id"] = int(eid)
    return md


def _merges_from_tokenizer_json(path: str | Path) -> list[str]:
    """BPE merge list from an HF tokenizer.json ("a b" strings; newer files
    store pairs) — emitted as tokenizer.ggml.merges so BPE-family
    conversions stay loadable by GGUF consumers that need merges."""
    import json

    with open(path, "rb") as f:
        tj = json.load(f)
    merges = (tj.get("model") or {}).get("merges") or []
    return [m if isinstance(m, str) else " ".join(m) for m in merges]


def convert_ggml_to_gguf(
    src: str | Path,
    dst: str | Path,
    architecture: str = "llama",
    tokenizer_json: "Optional[str | Path]" = None,
    chat_template: "Optional[str]" = None,
    extra_metadata: "Optional[dict]" = None,
) -> None:
    """Convert a classic GGML/GGJT checkpoint into GGUF v3 (all 7 archs)."""
    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.models.spec import get_arch

    arch_info = get_arch(architecture)
    reader = GgmlReader(src).load(
        lambda f: (lambda h: (h, h.n_vocab))(arch_info.read_hparams(f))
    )
    h = reader.hyperparameters
    to_gguf_name = gguf_name_fn(
        architecture, {"falcon.attention.head_count_kv": h.n_head_kv}
    )

    # feed_forward_length from the layer-0 up-projection's output dim (the
    # classic container never stores it; real checkpoints need it recorded
    # since e.g. llama-70B's n_ff is not derivable from n_mult rounding)
    table = _name_table(architecture, {})
    n_ff = None
    up_pat = table.get("blk.{}.ffn_up.weight")
    if up_pat:
        info0 = reader.tensors.get(up_pat.format(0))
        if info0 is not None and len(info0.dims) == 2:
            n_ff = int(info0.dims[1])

    with open(dst, "wb") as f:
        w = GgufWriter(f)
        md = arch_metadata(architecture, h, reader.vocabulary, n_ff=n_ff)
        if tokenizer_json:
            merges = _merges_from_tokenizer_json(tokenizer_json)
            if merges:
                md["tokenizer.ggml.model"] = "gpt2"
                md["tokenizer.ggml.merges"] = merges
        if chat_template:
            md["tokenizer.chat_template"] = chat_template
        if extra_metadata:
            # caller-known values the classic container cannot carry
            # (e.g. llama GQA head_count_kv from an HF config)
            md.update(extra_metadata)
        for k, v in md.items():
            w.add_metadata(k, v)
        for name, info in reader.tensors.items():
            w.add_tensor(
                to_gguf_name(name),
                info.element_type,
                info.dims,
                bytes(reader.fetch(name)),
            )
        w.finish()
