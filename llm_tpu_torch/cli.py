"""llm-tpu-torch command line interface: `infer` and `info`.

The counterpart of `llm_tpu/cli.py` for the subcommands this port has, with
the reference's flags for what it supports, plus `--device` (default: the
card; `--device cpu` runs the plain paths on the CPU).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np


def _err(msg: str) -> "NoReturn":  # noqa: F821
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(1)


def _batch_size(v: str):
    if v == "auto":
        return v
    return int(v)  # argparse reports ValueError as a usage error


def add_model_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model")
    g.add_argument("-m", "--model-path", required=True,
                   help="path to the model file")
    g.add_argument("-a", "--model-architecture", default=None,
                   help="model architecture (this port: llama)")
    g.add_argument("-v", "--tokenizer-path", default=None,
                   help="path to a HF tokenizer.json file")
    g.add_argument("-r", "--tokenizer-repository", default=None,
                   help="HF repository to load the tokenizer from")


def add_load_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model loading")
    g.add_argument("--num-ctx-tokens", type=int, default=2048,
                   help="size of the context window in tokens (default 2048)")
    g.add_argument("--rope-freq-base", type=int, default=None)
    g.add_argument("--rope-freq-scale", type=float, default=None)
    g.add_argument("--n-gqa", type=int, default=None,
                   help="grouped-query attention factor (LLaMA-70B: 8)")
    g.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")


def add_generate_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("generation")
    g.add_argument("-n", "--num-predict", type=int, default=None,
                   help="how many tokens to generate (default: until EOT)")
    g.add_argument("--batch-size", type=_batch_size, default=8,
                   help="prompt batch size (default 8, reference parity); "
                        "'auto' picks 512 on the card, 64 on the CPU")
    g.add_argument("-s", "--sampler", action="append", default=[],
                   dest="sampler_options", metavar="CONFIG",
                   help="sampler configuration `name:key=value:...` "
                        "(repetition, freqpresence, seqrepetition, topk, "
                        "tailfree, locallytypical, topp, topa, minp, "
                        "temperature, mirostat1, mirostat2)")
    g.add_argument("--seed", type=int, default=None, help="RNG seed")
    g.add_argument("--no-float16", action="store_true",
                   help="use 32-bit KV memory instead of 16-bit")
    g.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache: half the memory and traffic of "
                        "16-bit at a small quality cost")
    g.add_argument("--token-bias", default=None,
                   help="comma-separated TOKEN_ID=BIAS overrides")
    g.add_argument("--ignore-eos", action="store_true",
                   help="bias the EOT token to -inf so generation never stops")


def add_prompt_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-p", "--prompt", default=None,
                   help="the prompt (with -f, replaces {{PROMPT}} in the file)")
    p.add_argument("-f", "--prompt-file", default=None,
                   help="file containing the prompt")


def resolve_prompt(args) -> str:
    file_contents = None
    if getattr(args, "prompt_file", None):
        file_contents = Path(args.prompt_file).read_text()
        if file_contents.endswith("\r\n"):
            file_contents = file_contents[:-2]
        elif file_contents.endswith("\n"):
            file_contents = file_contents[:-1]
    prompt = getattr(args, "prompt", None)
    if file_contents is not None and prompt is not None:
        return file_contents.replace("{{PROMPT}}", prompt)
    if file_contents is not None:
        return file_contents
    if prompt is not None:
        return prompt
    _err("No prompt or prompt file was provided. See --help")


def tokenizer_source(args):
    from llm_tpu_torch.tokenizer import TokenizerSource

    if args.tokenizer_path and args.tokenizer_repository:
        _err("cannot specify both --tokenizer-path and --tokenizer-repository")
    if args.tokenizer_path:
        return TokenizerSource.hf_tokenizer_file(args.tokenizer_path)
    if args.tokenizer_repository:
        return TokenizerSource.hf_remote(args.tokenizer_repository)
    return TokenizerSource.embedded()


def load_model(args):
    from llm_tpu_torch.loader import ModelParameters, RoPEOverrides, load

    if not args.model_architecture:
        _err("a model architecture is required at present")
    rope = None
    if args.rope_freq_base is not None or args.rope_freq_scale is not None:
        rope = RoPEOverrides(
            frequency_base=args.rope_freq_base or 10000,
            frequency_scale=args.rope_freq_scale or 1.0,
        )
    params = ModelParameters(
        context_size=args.num_ctx_tokens,
        rope_overrides=rope,
        n_gqa=args.n_gqa,
    )

    def progress(ev):
        if ev.kind == "context_size":
            print(f"Model size: {ev.byte_size / 1e6:.1f} MB", file=sys.stderr)
        elif ev.kind == "tensor_loaded" and ev.current == ev.total:
            print(f"Loaded {ev.total} tensors", file=sys.stderr)

    return load(
        args.model_path,
        args.model_architecture,
        tokenizer_source=tokenizer_source(args),
        params=params,
        progress=progress,
        device=args.device,
    )


def session_config(args, model):
    from llm_tpu_torch.session import InferenceSessionConfig, ModelKVMemoryType

    if args.kv_int8:
        kv = ModelKVMemoryType.Int8
    elif args.no_float16:
        kv = ModelKVMemoryType.Float32
    else:
        kv = ModelKVMemoryType.Float16
    if str(args.batch_size) == "auto":
        n_batch = 512 if model.device.type == "cuda" else 64
    else:
        n_batch = int(args.batch_size)
    return InferenceSessionConfig(memory_k_type=kv, memory_v_type=kv,
                                  n_batch=n_batch)


def inference_parameters(args, model):
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.session import InferenceParameters
    from llm_tpu_torch.tokenizer import TokenBias

    bias = []
    if args.token_bias:
        bias = list(TokenBias.from_str(args.token_bias))
    elif args.ignore_eos:
        bias = [(model.eot_token_id(), float("-inf"))]
    sampler = build_sampler_chain(
        args.sampler_options, n_vocab=len(model.tokenizer), bias=bias
    )
    return InferenceParameters(sampler=sampler)


def _print_token(text: str) -> None:
    sys.stdout.write(text)
    sys.stdout.flush()


def cmd_infer(args) -> None:
    from llm_tpu_torch import session as S

    prompt = resolve_prompt(args)
    model = load_model(args)
    sess = S.InferenceSession(model, session_config(args, model))
    params = inference_parameters(args, model)
    rng = np.random.default_rng(args.seed)

    def callback(r):
        if r.kind == "prompt_token" and not args.hide_prompt:
            _print_token(r.text)
        elif r.kind == "inferred_token":
            _print_token(r.text)
        return S.InferenceFeedback.Continue

    try:
        stats = sess.infer(
            S.InferenceRequest(
                prompt=prompt,
                parameters=params,
                maximum_token_count=args.num_predict,
            ),
            rng=rng,
            callback=callback,
        )
        print()
        if args.stats:
            print()
            print(stats)
            print()
    except S.ContextFull:
        print()
        print("Context window full, stopping inference.", file=sys.stderr)


def cmd_info(args) -> None:
    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.models.spec import get_arch

    if not args.model_architecture:
        _err("a model architecture is required at present")
    arch = get_arch(args.model_architecture)
    reader = GgmlReader(args.model_path).load(
        lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f))
    )
    print(f"Container type: {reader.container!r}")
    print(f"Hyperparameters: {reader.hyperparameters}")
    print(f"Tokenizer vocabulary size: {len(reader.vocabulary)}")

    if args.tokenizer:
        print("Tokens:")
        for i, tok in enumerate(reader.vocabulary.tokens):
            try:
                s = tok.decode("utf-8")
            except UnicodeDecodeError:
                s = str(list(tok))
            print(f"- {i}: {s}")

    if args.tensors:
        print("Tensors:")
        for name, ti in reader.tensors.items():
            print(f"- {name} ({ti.element_type} {list(ti.dims)})")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="llm-tpu-torch",
        description="Inference of GGML block-quantized LLMs on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("infer", help="generate text from a prompt")
    add_model_args(p)
    add_load_args(p)
    add_generate_args(p)
    add_prompt_args(p)
    p.add_argument("--hide-prompt", action="store_true")
    p.add_argument("--stats", action="store_true")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("info", help="dump model metadata")
    add_model_args(p)
    p.add_argument("-t", "--tensors", action="store_true")
    p.add_argument("-k", "--tokenizer", action="store_true")
    p.set_defaults(fn=cmd_info)
    return parser


def main(argv: Optional[list[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
