"""Model-level loading: GGML/GGJT file -> ready-to-run Model.

The counterpart of `llm_tpu/loader.py`:

    container parse (hparams, vocab, tensor index) -> quantization-version
    check -> pack tensors on the device -> Model

Loading runs on the card unless the caller asks for the CPU: `device=None`
means "cuda", and raises when there is no GPU. All seven architectures
load (`models/params.build_params`), from the classic containers and from
GGUF v2/v3 (`ggml/gguf.py`, with the BPE tokenizer for gpt2-style
vocabularies). LoRA adapters (`lora.py`) patch a tensor's bytes on the
host before it is packed.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from llm_tpu_torch.ggml.gguf import GgufReader, is_gguf
from llm_tpu_torch.ggml.reader import GgmlReader
from llm_tpu_torch.ggml.types import ContainerType
from llm_tpu_torch.lora import LoraAdapter
from llm_tpu_torch.models.params import ModelParams, WeightSource, build_params
from llm_tpu_torch.models.spec import (
    ArchInfo,
    Hyperparameters,
    ModelSpec,
    get_arch,
    with_runtime_params,
)
from llm_tpu_torch.tokenizer import Tokenizer, TokenizerSource


class LoadError(Exception):
    pass


class MultipartNotSupported(LoadError):
    def __init__(self, paths):
        super().__init__(
            "Multipart models are not supported. Please convert the model to "
            f"a single part: {paths}"
        )


@dataclass
class RoPEOverrides:
    """ggml rope_custom overrides."""

    frequency_scale: float = 1.0
    frequency_base: int = 10000


@dataclass
class ModelParameters:
    """Runtime load parameters."""

    context_size: int = 2048
    lora_adapters: Optional[Sequence[str]] = None  # GGLA file paths
    rope_overrides: Optional[RoPEOverrides] = None
    n_gqa: Optional[int] = None


@dataclass
class LoadProgress:
    """One progress event; kind in {hyperparameters_loaded, context_size,
    tensor_loaded, loaded}."""

    kind: str
    current: int = 0
    total: int = 0
    byte_size: int = 0


ProgressCallback = Callable[[LoadProgress], None]

_GGUF_BYTE_TOKEN = re.compile(rb"^<0x([0-9A-Fa-f]{2})>$")


def _gguf_sp_token_bytes(tok: bytes) -> bytes:
    """GGUF SentencePiece surface form -> raw bytes: '▁' (U+2581) is
    the word boundary (space), '<0xNN>' tokens are single bytes."""
    m = _GGUF_BYTE_TOKEN.match(tok)
    if m:
        return bytes([int(m.group(1), 16)])
    return tok.replace("▁".encode(), b" ")


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def find_all_model_files(path: Path) -> list[Path]:
    """Reject multipart models."""
    path = Path(path)
    related = []
    for sib in sorted(path.parent.glob(f"{path.name}.*")):
        if re.fullmatch(r"\d+", sib.suffix.lstrip(".")):
            related.append(sib)
    if related:
        raise MultipartNotSupported([path, *related])
    return [path]


class Model:
    """A loaded model: static spec + packed params + tokenizer. Immutable
    after construction; any number of sessions may share it."""

    chat_template = None  # GGUF tokenizer.chat_template (HF jinja), if any

    def __init__(
        self,
        arch: ArchInfo,
        hyperparameters: Hyperparameters,
        spec: ModelSpec,
        params: ModelParams,
        tokenizer: Tokenizer,
        model_parameters: ModelParameters,
        container_type: ContainerType,
        device: torch.device,
    ):
        self.arch = arch
        self.hyperparameters = hyperparameters
        self.spec = spec
        self.params = params
        self.tokenizer = tokenizer
        self.model_parameters = model_parameters
        self.container_type = container_type
        self.device = device

    @property
    def context_size(self) -> int:
        return self.spec.n_ctx

    @property
    def supports_rewind(self) -> bool:
        return self.arch.supports_rewind

    def bot_token_id(self) -> Optional[int]:
        if self.arch.bot_token is None:
            return None
        return self.tokenizer.id(self.arch.bot_token.encode())

    def eot_token_id(self) -> int:
        tid = self.tokenizer.id(self.arch.eot_token.encode())
        if tid is None:
            if self.arch.eot_fallback_id is not None:
                return self.arch.eot_fallback_id
            raise LoadError(f"tokenizer has no {self.arch.eot_token!r} token")
        return tid

    def start_session(self, config=None):
        from llm_tpu_torch.session import (
            InferenceSession,
            InferenceSessionConfig,
        )

        return InferenceSession(self, config or InferenceSessionConfig())


def load(
    path: "str | Path",
    architecture: str,
    tokenizer_source: Optional[TokenizerSource] = None,
    params: Optional[ModelParameters] = None,
    progress: Optional[ProgressCallback] = None,
    device=None,
) -> Model:
    """Load a GGML/GGJT or GGUF model file for the named architecture onto
    `device` (default: the card)."""
    device = resolve_device(device)
    path = Path(path)
    params = params or ModelParameters()
    progress = progress or (lambda ev: None)
    arch = get_arch(architecture)

    find_all_model_files(path)

    tokenizer_source = tokenizer_source or TokenizerSource.embedded()
    external_tokenizer = tokenizer_source.retrieve()

    if is_gguf(path):
        # hyperparameters come from the metadata store; tensor names are
        # translated to the classic names at index time (ggml/gguf.py)
        reader = GgufReader(path).load(architecture)
    else:
        reader = GgmlReader(path).load(
            lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f))
        )
    hp: Hyperparameters = reader.hyperparameters
    progress(LoadProgress("hyperparameters_loaded"))

    # quantization-version guess + assertion
    qv = hp.file_type.quantization_version
    if qv == 0:
        if reader.container == ContainerType("ggjt", 2):
            qv = 1
        elif reader.container == ContainerType("ggjt", 3):
            qv = 2
    if any(t.element_type.is_quantized for t in reader.tensors.values()):
        if qv != 2:
            raise LoadError(
                f"quantization version must be 2, got {qv} "
                "(requantize this model with a current converter)"
            )

    md = getattr(reader, "metadata", {}) or {}
    if external_tokenizer is not None:
        tokenizer = external_tokenizer
    elif md.get("tokenizer.ggml.model") in (b"gpt2", "gpt2") and md.get(
            "tokenizer.ggml.merges"):
        # a GGUF BPE vocabulary (mapped-form tokens + ranked merges): its
        # scores mean nothing, so the score-greedy tokenizer would split
        # words wrongly
        from llm_tpu_torch.tokenizer.bpe import BpeTokenizer

        bos = md.get("tokenizer.ggml.bos_token_id")
        tokenizer = Tokenizer(BpeTokenizer(
            reader.vocabulary.tokens,
            md["tokenizer.ggml.merges"],
            token_types=md.get("tokenizer.ggml.token_type"),
            bos_id=int(bos) if bos is not None else None,
        ))
    else:
        from llm_tpu_torch.tokenizer.embedded import EmbeddedTokenizer

        toks = reader.vocabulary.tokens
        if "tokenizer.ggml.tokens" in md:
            # GGUF stores SentencePiece surface forms ('▁hello', literal
            # '<0xNN>' byte tokens) and the embedded tokenizer works on
            # bytes; control tokens (type 3) keep their text. The reader's
            # vocabulary stays as it is, so a GGUF rewrite passes the
            # surface forms through.
            types = md.get("tokenizer.ggml.token_type") or []
            toks = [t if i < len(types) and types[i] == 3
                    else _gguf_sp_token_bytes(t)
                    for i, t in enumerate(toks)]
        emb = EmbeddedTokenizer()
        for i, (tok, score) in enumerate(zip(toks, reader.vocabulary.scores)):
            emb.push_token(i, tok, score)
        tokenizer = Tokenizer(emb)

    lora_adapters = [LoraAdapter(p) for p in (params.lora_adapters or [])]

    total_bytes = sum(t.calc_size() for t in reader.tensors.values())
    progress(LoadProgress("context_size", byte_size=total_bytes))

    # a --rope-* override wins; else the file's own rope settings (GGUF
    # metadata; None for the classic containers)
    rope = params.rope_overrides
    spec = with_runtime_params(
        arch.make_spec(hp),
        context_size=params.context_size,
        n_gqa=params.n_gqa,
        rope_freq_base=(float(rope.frequency_base) if rope
                        else hp.rope_freq_base),
        rope_freq_scale=(rope.frequency_scale if rope
                         else hp.rope_freq_scale),
    )
    if params.n_gqa is not None and spec.arch == "llama":
        hp.n_head_kv = spec.n_head_kv
    if spec.learned_pos:
        # a learned position table (GPT-2's wpe) caps the context at its
        # height, as the reference's loader does: past it the position
        # lookup would index beyond the table
        file_ctx = getattr(hp, "n_ctx", 0) or 0
        if file_ctx and spec.n_ctx > file_ctx:
            spec = with_runtime_params(spec, context_size=file_ctx)

    def tensor_progress(name: str, current: int, total: int) -> None:
        progress(LoadProgress("tensor_loaded", current=current, total=total))

    # the pre-packed plane cache (cli `pack`): a valid cache next to the
    # file skips the transcode; LoRA loads bypass it (patched planes), and
    # LLM_TPU_PACK_CACHE=0 turns it off (e.g. to time the cold path)
    model_params = None
    if not lora_adapters and os.environ.get("LLM_TPU_PACK_CACHE") != "0":
        from llm_tpu_torch.models.pack_cache import (
            cache_key,
            load_packed_params,
            pack_path,
        )

        pp = pack_path(path)
        if pp.exists():
            model_params = load_packed_params(
                pp, cache_key(path, n_gqa=params.n_gqa), device)
    if model_params is None:
        ws = WeightSource(reader, device, progress=tensor_progress,
                          lora_adapters=lora_adapters)
        model_params = build_params(ws, spec)
    progress(LoadProgress("loaded", byte_size=total_bytes))

    model = Model(
        arch=arch,
        hyperparameters=hp,
        spec=spec,
        params=model_params,
        tokenizer=tokenizer,
        model_parameters=params,
        container_type=reader.container,
        device=device,
    )
    # a GGUF file may carry the HF-convention jinja chat template
    tmpl = md.get("tokenizer.chat_template")
    if isinstance(tmpl, bytes):
        tmpl = tmpl.decode("utf-8", errors="replace")
    model.chat_template = tmpl
    return model
