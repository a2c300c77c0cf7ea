"""Architecture descriptors: hyperparameter codecs and the static ModelSpec.

One declarative table replaces the reference's seven per-architecture crates
(llm/crates/models/*). Differences between architectures are
normalized at load time (fused-QKV layouts are split into canonical q/k/v,
see params.py), so the runtime graph is ONE spec-driven decoder
(models/forward.py) — the TPU-first design from SURVEY.md §7 step 4.

Hyperparameter on-disk codecs mirror each crate's Hyperparameters::read_ggml /
write_ggml exactly (LE i32 fields; file:line cited per arch below).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, replace
from typing import BinaryIO, Callable, Optional

from llm_tpu_torch.ggml.types import FileType

# ---------------------------------------------------------------------------
# static model spec (hashable -> usable as a jit static argument)


@dataclass(frozen=True)
class ModelSpec:
    """Everything the jitted forward pass needs to know statically."""

    arch: str
    n_vocab: int
    n_embd: int
    n_head: int
    n_head_kv: int
    n_layer: int
    n_rot: int  # rotary dims (0 = no rope)
    n_ctx: int  # runtime context window (ModelParameters::context_size)

    # normalization: "rms" (eps 5e-6) or "ln" (eps 1e-5)
    norm: str = "ln"
    norm_has_bias: bool = True
    post_embed_norm: bool = False  # bloom: LN right after embedding lookup

    # positional scheme
    rope_mode: int = -1  # 0 = GPT interleaved, 2 = NeoX, -1 = none
    learned_pos: bool = False  # gpt2 wpe
    alibi_bias_max: float = 0.0  # >0 enables ALiBi (bloom 8.0, mpt from file)
    rope_freq_base: float = 10000.0
    rope_freq_scale: float = 1.0

    # residual topology: "sequential" | "parallel_shared_ln" | "parallel_two_ln"
    residual: str = "sequential"

    # feed-forward: "gelu" | "swiglu"
    ffn: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kq_scale(self) -> float:
        # all reference archs scale by 1/sqrt(n_embd/n_head), even with GQA
        return 1.0 / (self.n_embd / self.n_head) ** 0.5


@dataclass(frozen=True)
class ShardSpec(ModelSpec):
    """One rank's view of a tensor-parallel model (parallel/sharding.py).

    `n_head` and `n_head_kv` are the rank's own heads, used only to shape
    its tensors; every other field is the model's. `head_dim`, the
    attention scale 1/sqrt(n_embd/n_head) and the ALiBi slopes come from
    the model's head counts (`n_head_global`, `n_head_kv_global`); the
    slopes are sliced to the rank's kv heads from `kv_start` on. `tp`
    carries the rank's collectives and which layer groups are sharded."""

    n_head_global: int = 0
    n_head_kv_global: int = 0
    kv_start: int = 0
    tp: object = field(default=None, compare=False, hash=False, repr=False)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head_global

    @property
    def kq_scale(self) -> float:
        return 1.0 / (self.n_embd / self.n_head_global) ** 0.5


# ---------------------------------------------------------------------------
# hyperparameters (on-disk codec)


class HyperparametersError(ValueError):
    pass


def _read4(f: BinaryIO) -> bytes:
    b = f.read(4)
    if len(b) != 4:  # typed error (never struct.error) on truncation
        raise HyperparametersError(
            "unexpected end of file in hyperparameters"
        )
    return b


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", _read4(f))[0]


def _read_f32(f: BinaryIO) -> float:
    return struct.unpack("<f", _read4(f))[0]


@dataclass
class Hyperparameters:
    """Model-file hyperparameters; field order == on-disk order per arch."""

    arch: str
    n_vocab: int = 0
    n_ctx: int = 0  # stored by gpt2/gptj/gptneox; 0 elsewhere
    n_embd: int = 0
    n_mult: int = 0  # llama/bloom
    n_head: int = 0
    n_head_kv: int = 0
    n_layer: int = 0
    n_rot: int = 0
    use_parallel_residual: bool = True  # gptneox
    max_seq_len: int = 0  # mpt
    alibi_bias_max: float = 0.0  # mpt
    clip_kqv: float = 0.0  # mpt (read but unused in the graph, mpt/src/lib.rs)
    file_type: FileType = field(default_factory=lambda: FileType.from_i32(0))
    # GGUF-only: rope settings baked into the checkpoint metadata
    # ({arch}.rope.freq_base / rope.scale_linear / rope.scaling.factor) —
    # classic GGML has no analog; CLI --rope-freq-* overrides still win
    rope_freq_base: Optional[float] = None
    rope_freq_scale: Optional[float] = None

    def write_ggml(self, f: BinaryIO) -> None:
        _ARCHS[self.arch].write_hparams(self, f)


@dataclass(frozen=True)
class ArchInfo:
    """Declarative per-architecture description."""

    name: str
    read_hparams: Callable[[BinaryIO], Hyperparameters]
    write_hparams: Callable[[Hyperparameters, BinaryIO], None]
    make_spec: Callable[[Hyperparameters], ModelSpec]
    # token strings for bot/eot lookup (KnownModel::{bot,eot}_token_id)
    bot_token: Optional[str] = None
    eot_token: str = "<|endoftext|>"
    eot_fallback_id: Optional[int] = None  # llama: "</s>" -> 2 if not found
    quantize_patterns: tuple = (r".*weight",)
    skip_quantize_patterns: tuple = ()
    supports_rewind: bool = True


def _w_i32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<i", v))


def _w_f32(f: BinaryIO, v: float) -> None:
    f.write(struct.pack("<f", v))


def _read_ftype(f: BinaryIO) -> FileType:
    return FileType.from_i32(_read_i32(f))


# --- llama (crates/models/llama/src/lib.rs:424-458) ------------------------


def _read_llama(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="llama")
    h.n_vocab = _read_i32(f)
    h.n_embd = _read_i32(f)
    h.n_mult = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.n_rot = _read_i32(f)
    h.file_type = _read_ftype(f)
    h.n_head_kv = h.n_head  # GQA only via explicit --n-gqa (lib.rs:107-117)
    return h


def _write_llama(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_vocab)
    _w_i32(f, h.n_embd)
    _w_i32(f, h.n_mult)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.n_rot)
    _w_i32(f, h.file_type.to_i32())


def _spec_llama(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="llama",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head_kv or h.n_head,
        n_layer=h.n_layer,
        n_rot=h.n_rot,
        n_ctx=0,
        norm="rms",
        norm_has_bias=False,
        rope_mode=0,
        residual="sequential",
        ffn="swiglu",
    )


# --- gpt2 (crates/models/gpt2/src/lib.rs:393-428; double n_vocab) ----------


def _read_gpt2(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="gpt2")
    h.n_vocab = _read_i32(f)
    h.n_ctx = _read_i32(f)
    h.n_embd = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.file_type = _read_ftype(f)
    n_vocab2 = _read_i32(f)
    if n_vocab2 != h.n_vocab:
        raise HyperparametersError(
            f"GPT2 model expected n_vocab {h.n_vocab} found {n_vocab2}"
        )
    h.n_head_kv = h.n_head
    return h


def _write_gpt2(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_vocab)
    _w_i32(f, h.n_ctx)
    _w_i32(f, h.n_embd)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.file_type.to_i32())
    _w_i32(f, h.n_vocab)


def _spec_gpt2(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="gpt2",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head,
        n_layer=h.n_layer,
        n_rot=0,
        n_ctx=0,
        norm="ln",
        learned_pos=True,
        residual="sequential",
        ffn="gelu",
    )


# --- gptj (crates/models/gptj/src/lib.rs:365-401; double n_vocab) ----------


def _read_gptj(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="gptj")
    h.n_vocab = _read_i32(f)
    h.n_ctx = _read_i32(f)
    h.n_embd = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.n_rot = _read_i32(f)
    h.file_type = _read_ftype(f)
    n_vocab2 = _read_i32(f)
    if n_vocab2 != h.n_vocab:
        raise HyperparametersError(
            f"GPTJ model expected n_vocab {h.n_vocab} found {n_vocab2}"
        )
    h.n_head_kv = h.n_head
    return h


def _write_gptj(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_vocab)
    _w_i32(f, h.n_ctx)
    _w_i32(f, h.n_embd)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.n_rot)
    _w_i32(f, h.file_type.to_i32())
    _w_i32(f, h.n_vocab)


def _spec_gptj(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="gptj",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head,
        n_layer=h.n_layer,
        n_rot=h.n_rot,
        n_ctx=0,
        norm="ln",
        rope_mode=0,
        residual="parallel_shared_ln",
        ffn="gelu",
    )


# --- gptneox (crates/models/gptneox/src/lib.rs:430-454) --------------------


def _read_gptneox(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="gptneox")
    h.n_vocab = _read_i32(f)
    h.n_ctx = _read_i32(f)
    h.n_embd = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.n_rot = _read_i32(f)
    h.use_parallel_residual = _read_i32(f) != 0  # util::read_bool: i32
    h.file_type = _read_ftype(f)
    h.n_head_kv = h.n_head
    return h


def _write_gptneox(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_vocab)
    _w_i32(f, h.n_ctx)
    _w_i32(f, h.n_embd)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.n_rot)
    _w_i32(f, 1 if h.use_parallel_residual else 0)
    _w_i32(f, h.file_type.to_i32())


def _spec_gptneox(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="gptneox",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head,
        n_layer=h.n_layer,
        n_rot=h.n_rot,
        n_ctx=0,
        norm="ln",
        rope_mode=2,
        residual="parallel_two_ln" if h.use_parallel_residual else "sequential",
        ffn="gelu",
    )


# --- bloom (crates/models/bloom/src/lib.rs:394-413) ------------------------


def _read_bloom(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="bloom")
    h.n_vocab = _read_i32(f)
    h.n_embd = _read_i32(f)
    h.n_mult = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.file_type = _read_ftype(f)
    h.n_head_kv = h.n_head
    return h


def _write_bloom(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_vocab)
    _w_i32(f, h.n_embd)
    _w_i32(f, h.n_mult)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.file_type.to_i32())


def _spec_bloom(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="bloom",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head,
        n_layer=h.n_layer,
        n_rot=0,
        n_ctx=0,
        norm="ln",
        post_embed_norm=True,
        alibi_bias_max=8.0,  # hardcoded in bloom/src/lib.rs:240
        residual="sequential",
        ffn="gelu",
    )


# --- mpt (crates/models/mpt/src/lib.rs:296-330) ----------------------------


def _read_mpt(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="mpt")
    h.n_embd = _read_i32(f)
    h.max_seq_len = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.n_vocab = _read_i32(f)
    h.alibi_bias_max = _read_f32(f)
    h.clip_kqv = _read_f32(f)
    h.file_type = _read_ftype(f)
    h.n_head_kv = h.n_head
    return h


def _write_mpt(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_embd)
    _w_i32(f, h.max_seq_len)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.n_vocab)
    _w_f32(f, h.alibi_bias_max)
    _w_f32(f, h.clip_kqv)
    _w_i32(f, h.file_type.to_i32())


def _spec_mpt(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="mpt",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head,
        n_layer=h.n_layer,
        n_rot=0,
        n_ctx=0,
        norm="ln",
        norm_has_bias=False,
        alibi_bias_max=h.alibi_bias_max,
        residual="sequential",
        ffn="gelu",
    )


# --- falcon (crates/models/falcon/src/lib.rs:413-447) ----------------------


def _read_falcon(f: BinaryIO) -> Hyperparameters:
    h = Hyperparameters(arch="falcon")
    h.n_vocab = _read_i32(f)
    h.n_embd = _read_i32(f)
    h.n_head = _read_i32(f)
    h.n_head_kv = _read_i32(f)
    h.n_layer = _read_i32(f)
    h.file_type = _read_ftype(f)
    return h


def _write_falcon(h: Hyperparameters, f: BinaryIO) -> None:
    _w_i32(f, h.n_vocab)
    _w_i32(f, h.n_embd)
    _w_i32(f, h.n_head)
    _w_i32(f, h.n_head_kv)
    _w_i32(f, h.n_layer)
    _w_i32(f, h.file_type.to_i32())


def _spec_falcon(h: Hyperparameters) -> ModelSpec:
    return ModelSpec(
        arch="falcon",
        n_vocab=h.n_vocab,
        n_embd=h.n_embd,
        n_head=h.n_head,
        n_head_kv=h.n_head_kv,
        n_layer=h.n_layer,
        n_rot=h.n_embd // h.n_head,  # rope over full head_dim (lib.rs:245)
        n_ctx=0,
        norm="ln",
        rope_mode=2,
        # 7B (n_head_kv==1): one LN feeds both branches; 40B: ln_attn/ln_mlp
        residual="parallel_shared_ln" if h.n_head_kv == 1 else "parallel_two_ln",
        ffn="gelu",
    )


# ---------------------------------------------------------------------------
# registry (the analog of llm's define_models!, crates/llm/src/lib.rs:95-182)

_ARCHS: dict[str, ArchInfo] = {
    "llama": ArchInfo(
        "llama",
        _read_llama,
        _write_llama,
        _spec_llama,
        bot_token=None,
        eot_token="</s>",
        eot_fallback_id=2,
    ),
    "gpt2": ArchInfo(
        "gpt2",
        _read_gpt2,
        _write_gpt2,
        _spec_gpt2,
        quantize_patterns=(
            r"model/wte",
            r"model/lm_head",
            r"model/h.*/attn/c_attn/w",
            r"model/h.*/attn/c_proj/w",
            r"model/h.*/mlp/c_fc/w",
            r"model/h.*/mlp/c_proj/w",
        ),
        supports_rewind=False,
    ),
    "gptj": ArchInfo("gptj", _read_gptj, _write_gptj, _spec_gptj),
    "gptneox": ArchInfo("gptneox", _read_gptneox, _write_gptneox, _spec_gptneox),
    "bloom": ArchInfo(
        "bloom",
        _read_bloom,
        _write_bloom,
        _spec_bloom,
        bot_token="<s>",
        eot_token="</s>",
    ),
    "mpt": ArchInfo(
        "mpt",
        _read_mpt,
        _write_mpt,
        _spec_mpt,
        bot_token="<|padding|>",
    ),
    "falcon": ArchInfo("falcon", _read_falcon, _write_falcon, _spec_falcon),
}

SUPPORTED_ARCHITECTURES = tuple(_ARCHS)


class UnsupportedModelArchitecture(ValueError):
    pass


def get_arch(name: str) -> ArchInfo:
    """ModelArchitecture::from_str analog (crates/llm/src/lib.rs:229-249)."""
    key = name.strip().lower().replace("-", "").replace("_", "")
    aliases = {"gptneox": "gptneox", "stablelm": "gptneox", "redpajama": "gptneox"}
    key = aliases.get(key, key)
    if key not in _ARCHS:
        raise UnsupportedModelArchitecture(
            f"{name} is not one of supported model architectures: "
            f"{list(_ARCHS)}"
        )
    return _ARCHS[key]


def with_runtime_params(
    spec: ModelSpec,
    *,
    context_size: int = 2048,
    n_gqa: Optional[int] = None,
    rope_freq_base: Optional[float] = None,
    rope_freq_scale: Optional[float] = None,
) -> ModelSpec:
    """Apply ModelParameters-style runtime overrides (model/mod.rs:196-229)."""
    spec = replace(spec, n_ctx=context_size)
    if n_gqa is not None and spec.arch == "llama":
        if spec.n_layer >= 80:
            assert spec.n_head % n_gqa == 0, (
                "assuming 70B Llama2 model based on GQA == 8"
            )
            spec = replace(spec, n_head_kv=spec.n_head // n_gqa)
    if rope_freq_base is not None:
        spec = replace(spec, rope_freq_base=rope_freq_base)
    if rope_freq_scale is not None:
        spec = replace(spec, rope_freq_scale=rope_freq_scale)
    return spec
