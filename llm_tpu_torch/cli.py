"""llm-tpu-torch command line interface: `infer`, `info` and `serve`.

The counterpart of `llm_tpu/cli.py` for the subcommands this port has, with
the reference's flags for what it supports, plus `--device` (default: the
card; `--device cpu` runs the plain paths on the CPU).
"""

from __future__ import annotations

import argparse
import os
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
    g.add_argument("--device-sampling", action="store_true",
                   help="sample on the device, N tokens a block (greedy, or "
                        "temperature/top-k/top-p/min-p/tailfree/"
                        "locallytypical/topa/mirostat1/mirostat2/repetition/"
                        "freqpresence from -s); on the card each token is "
                        "one CUDA graph replay. seqrepetition stays "
                        "host-only")
    g.add_argument("--decode-steps", type=int, default=32,
                   help="tokens generated per block with --device-sampling")


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


def _kv_get(kv: dict, field: str, default):
    """Prefix-match option keys as the host chain does
    (field.startswith(key)), so freqpresence:freq=0.7 means the same on
    both paths."""
    for k, v in kv.items():
        if field.startswith(k.strip().lower()):
            return v
    return default


def _primary(kv: dict, rest: str, field: str, default):
    """The host DSL's rule: a keyless part is the sampler's primary value;
    else the prefix-matched key=value; else the host class default."""
    for part in filter(None, rest.split(":")):
        if "=" not in part:
            return part.strip()
    return _kv_get(kv, field, default)


def device_sampler(args, model):
    """(DeviceSampler, halt_on_eot) from the sampler DSL options,
    --token-bias and --ignore-eos. Raises SystemExit for a sampler the
    device path lacks and for an invalid mirostat combination."""
    from llm_tpu_torch.ops.sampling import DeviceSampler
    from llm_tpu_torch.tokenizer import TokenBias

    temp, topk, topp, minp = None, 0, 1.0, 0.0
    rep, last_n, freq, pres = 1.0, 64, 0.0, 0.0
    tfz, typ, topa = 1.0, 1.0, (0.0, 0.0)
    miro, mtau, meta, mm = 0, 5.0, 0.1, 100
    for opt in args.sampler_options:
        name, _, rest = opt.partition(":")
        key = name.strip().lower().replace("-", "").replace("_", "")
        kv = dict(kvp.split("=", 1) for kvp in rest.split(":") if "=" in kvp)
        if key == "temperature":
            temp = float(_primary(kv, rest, "temperature", 0.8))
        elif key == "topk":
            topk = int(_primary(kv, rest, "k", 40))
        elif key == "topp":
            topp = float(_primary(kv, rest, "p", 0.95))
        elif key == "minp":
            minp = float(_primary(kv, rest, "p", 0.0))
        elif key == "tailfree":
            tfz = float(_primary(kv, rest, "z", 1.0))
        elif key == "locallytypical":
            typ = float(_primary(kv, rest, "p", 1.0))
        elif key == "topa":
            topa = (float(_kv_get(kv, "a1", 0.0)),
                    float(_kv_get(kv, "a2", 0.0)))
        elif key in ("mirostat1", "mirostat2"):
            miro = 1 if key == "mirostat1" else 2
            mtau = float(_kv_get(kv, "tau", 5.0))
            meta = float(_kv_get(kv, "eta", 0.1))
            mm = int(_kv_get(kv, "m", 100))
            if temp is None:
                temp = 0.8  # the mirostat terminal still samples
        elif key == "repetition":
            rep = float(_kv_get(kv, "penalty", 1.3))
            last_n = int(_kv_get(kv, "last_n", last_n))
        elif key == "freqpresence":
            freq = float(_kv_get(kv, "frequency", 0.0))
            pres = float(_kv_get(kv, "presence", 0.0))
            last_n = int(_kv_get(kv, "last_n", last_n))
        else:
            raise SystemExit(
                f"sampler {name!r} is not available on the device "
                "path (--device-sampling); drop the flag to use the "
                "host chain"
            )
    # --token-bias / --ignore-eos ride the flat bias, with the host chain's
    # precedence
    if args.token_bias:
        bias = tuple(TokenBias.from_str(args.token_bias))
    elif args.ignore_eos:
        bias = ((model.eot_token_id(), float("-inf")),)
    else:
        bias = ()
    eot = model.eot_token_id()
    halt_on_eot = not any(t == eot and b == float("-inf") for t, b in bias)
    penalties = dict(repeat_penalty=rep, frequency_penalty=freq,
                     presence_penalty=pres, penalty_last_n=last_n)
    if (temp is None and topk == 0 and topp >= 1.0 and minp <= 0.0
            and tfz >= 1.0 and typ >= 1.0 and topa == (0.0, 0.0)
            and miro == 0):
        return DeviceSampler(kind="greedy", bias=bias, **penalties), \
            halt_on_eot
    try:
        sampler = DeviceSampler(
            kind="sample", temperature=temp or 0.8, top_k=topk, top_p=topp,
            min_p=minp, tail_free_z=tfz, typical_p=typ, top_a=topa,
            mirostat=miro, mirostat_tau=mtau, mirostat_eta=meta,
            mirostat_m=mm, bias=bias, **penalties,
        )
    except ValueError as e:
        raise SystemExit(f"invalid sampler combination: {e}")
    return sampler, halt_on_eot


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

    if args.device_sampling:
        sampler, halt_on_eot = device_sampler(args, model)
        try:
            stats = sess.infer_device(
                prompt,
                args.num_predict if args.num_predict is not None else 2**31,
                sampler=sampler,
                n_steps=args.decode_steps,
                # an unseeded run varies from run to run, as the host path's
                # default_rng(None) does
                seed=(args.seed if args.seed is not None
                      else int.from_bytes(os.urandom(4), "little")),
                callback=_print_token,
                halt_on_eot=halt_on_eot,
            )
            print()
            if args.stats:
                print()
                print(stats)
                print()
        except S.ContextFull:
            print()
            print("Context window full, stopping inference.", file=sys.stderr)
        return

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


def cmd_serve(args) -> None:
    """HTTP serving over the continuous-batching engine (dense or paged)."""
    import torch

    from llm_tpu_torch.server import serve_forever

    # pure-argument validation BEFORE the multi-GB model load
    if args.kv_int4 and not args.paged:
        raise SystemExit("--kv-int4 requires --paged (pool-only format)")
    if args.kv_int4 and args.kv_int8:
        raise SystemExit("--kv-int4 and --kv-int8 conflict; pick one")
    if args.prefix_cache and not args.paged:
        raise SystemExit("--prefix-cache requires --paged")

    model = load_model(args)
    try:
        serve_forever(
            model,
            host=args.host,
            port=args.port,
            max_streams=args.max_streams,
            kv_dtype=("int4" if args.kv_int4 else
                      "int8" if args.kv_int8 else torch.bfloat16),
            n_batch=args.batch_size,
            paged=args.paged,
            page_size=args.page_size,
            n_pages=args.n_pages,
            prefix_cache=args.prefix_cache,
            multi_step=args.multi_step,
            warmup=not args.no_warmup,
        )
    except KeyboardInterrupt:
        pass


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

    p = sub.add_parser(
        "serve",
        help="HTTP server (OpenAI-style /v1/completions; SSE streaming) "
        "over the continuous-batching engine",
    )
    add_model_args(p)
    add_load_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-streams", type=int, default=8,
                   help="continuous-batching slots")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (halves KV memory vs bf16)")
    p.add_argument("--kv-int4", action="store_true",
                   help="int4 paged KV pool (nibble-packed codes + per-row "
                   "scales); requires --paged")
    p.add_argument("--batch-size", type=int, default=64,
                   help="prefill chunk size per engine step")
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool instead of dense per-slot cache")
    p.add_argument("--page-size", type=int, default=256)
    p.add_argument("--n-pages", type=int, default=None,
                   help="page-pool size (paged engines; default: every "
                   "stream can reach full context)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="reuse full prompt-prefix KV pages across requests "
                   "(exact-match, refcounted, LRU-evicted under pool "
                   "pressure; requires --paged)")
    p.add_argument("--multi-step", type=int, default=0,
                   help="decode N tokens per device dispatch when every "
                   "active request's sampling is device-expressible "
                   "(greedy / temperature / top-k / top-p / min-p / "
                   "penalties)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warm-up request")
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv: Optional[list[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
