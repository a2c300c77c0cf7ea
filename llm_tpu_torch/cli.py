"""llm-tpu-torch command line interface: `infer`, `perplexity`, `info`,
`verify`, `prompt-tokens`, `repl`, `chat`, `gguf-convert`, `serve`,
`convert-hf` and `quantize`.

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
                   help="model architecture (llama, gpt2, gptj, gptneox, "
                        "bloom, mpt, falcon)")
    g.add_argument("-v", "--tokenizer-path", default=None,
                   help="path to a HF tokenizer.json file")
    g.add_argument("-r", "--tokenizer-repository", default=None,
                   help="HF repository to load the tokenizer from")


def add_load_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model loading")
    g.add_argument("--num-ctx-tokens", type=int, default=2048,
                   help="size of the context window in tokens (default 2048)")
    g.add_argument("--no-mmap", action="store_true",
                   help="accepted for parity; loading always streams+packs")
    g.add_argument("--lora-paths", nargs="*", default=None,
                   help="LoRA adapter (GGLA) files to apply")
    g.add_argument("--gpu-layers", type=int, default=None,
                   help="accepted for parity; every layer stays on the "
                        "device")
    g.add_argument("--rope-freq-base", type=int, default=None)
    g.add_argument("--rope-freq-scale", type=float, default=None)
    g.add_argument("--n-gqa", type=int, default=None,
                   help="grouped-query attention factor (LLaMA-70B: 8)")
    g.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")


def add_generate_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("generation")
    g.add_argument("-t", "--num-threads", type=int, default=None,
                   help="accepted for parity (recorded in session "
                        "snapshots); torch owns the device's parallelism")
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
    g.add_argument("--use-gpu", action="store_true",
                   help="accepted for parity; compute runs on --device")
    g.add_argument("--device-sampling", action="store_true",
                   help="sample on the device, N tokens a block (greedy, or "
                        "temperature/top-k/top-p/min-p/tailfree/"
                        "locallytypical/topa/mirostat1/mirostat2/repetition/"
                        "freqpresence from -s); on the card each token is "
                        "one CUDA graph replay. seqrepetition stays "
                        "host-only")
    g.add_argument("--decode-steps", type=int, default=32,
                   help="tokens generated per block with --device-sampling")
    g.add_argument("--draft-model", default=None,
                   help="speculative decoding: path to a small draft model "
                        "of the same vocabulary, loaded on the same device "
                        "and context (greedy sampling only; the output is "
                        "plain greedy decoding, up to argmax ties on the "
                        "card)")


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
        lora_adapters=args.lora_paths,
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
                                  n_batch=n_batch,
                                  n_threads=args.num_threads or 8)


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


def load_draft(args):
    """The --draft-model file, on the target's device and context."""
    from llm_tpu_torch.loader import ModelParameters, load

    return load(args.draft_model, args.model_architecture,
                tokenizer_source=tokenizer_source(args),
                params=ModelParameters(context_size=args.num_ctx_tokens),
                device=args.device)


def _infer_speculative(args, model) -> None:
    import time

    import torch

    from llm_tpu_torch.speculative import SpeculativeSession
    from llm_tpu_torch.tokenizer import Prompt, TokenUtf8Buffer

    draft = load_draft(args)
    if args.kv_int8:
        kv_dtype = "int8"
    elif args.no_float16:
        kv_dtype = torch.float32
    else:
        kv_dtype = torch.bfloat16
    s = SpeculativeSession(model, draft, k=4, kv_dtype=kv_dtype,
                           n_batch=session_config(args, model).n_batch)
    prompt = resolve_prompt(args)
    toks = Prompt.of(prompt).to_tokens(model.tokenizer, True)
    if not args.hide_prompt:
        print(prompt, end="", flush=True)
    t0 = time.monotonic()
    s.feed_prompt(toks)

    decoded = [len(model.tokenizer.decode(s.tokens, True))]
    utf8 = TokenUtf8Buffer()  # hold back split multi-byte characters

    def emit(tok):
        # whole-sequence decode diff; the UTF-8 buffer keeps a character
        # whose bytes span two accepted tokens from printing as garbage
        if tok == model.eot_token_id():
            return
        text = model.tokenizer.decode(s.tokens, True)
        piece = utf8.push(text[decoded[0]:])
        decoded[0] = len(text)
        if piece:
            sys.stdout.write(piece)
            sys.stdout.flush()

    out = s.generate(
        args.num_predict if args.num_predict is not None else 2**31,
        callback=emit,
    )
    dt = time.monotonic() - t0
    print(file=sys.stderr)
    if args.stats:
        print(
            f"predict_tokens: {len(out)}\n"
            f"per_token_duration: {dt / max(len(out), 1) * 1e3:.3f}ms\n"
            f"draft_acceptance: {s.acceptance_rate:.2f}",
            file=sys.stderr,
        )


def cmd_infer(args) -> None:
    from llm_tpu_torch import session as S
    from llm_tpu_torch import snapshot as snap

    # pure-argument validation BEFORE the multi-GB model load
    if args.draft_model:
        if args.sampler_options or args.device_sampling:
            _err("--draft-model supports greedy sampling only")
        if args.token_bias or args.ignore_eos:
            _err("--draft-model does not support --token-bias/--ignore-eos "
                 "(greedy acceptance has no bias hook)")
        if args.load_session or args.save_session or args.persist_session:
            _err("--draft-model does not support session snapshots")
    prompt = resolve_prompt(args)
    model = load_model(args)
    if args.draft_model:
        return _infer_speculative(args, model)
    persist = Path(args.persist_session) if args.persist_session else None
    load_path = Path(args.load_session) if args.load_session else None
    sess, session_loaded = snap.read_or_create_session(
        model, persist, load_path, session_config(args, model)
    )
    save_to = args.save_session or args.persist_session
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
        if save_to:
            snap.write_session(sess, save_to)
        return

    try:
        stats = sess.infer(
            S.InferenceRequest(
                prompt=prompt,
                parameters=params,
                play_back_previous_tokens=session_loaded,
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

    if save_to:
        snap.write_session(sess, save_to)
        print(f"Successfully wrote session to {save_to}", file=sys.stderr)


def cmd_perplexity(args) -> None:
    from llm_tpu_torch.session import InferenceSession

    prompt = resolve_prompt(args)
    model = load_model(args)
    sess = InferenceSession(model, session_config(args, model))
    sess.perplexity(
        prompt, lambda chunk, ppl: print(f"Perplexity[{chunk}]: {ppl}")
    )


def cmd_verify(args) -> None:
    """The llm-test golden cases (Inference / Tokens / Delete /
    hyperparameter round-trip / CanSend) and an optional perplexity gate
    against a local model file. With --config, goldens, url and sha256
    come from a llm-test style JSON (test_configs/real/*.json); -m
    overrides its model path."""
    import json as _json

    from llm_tpu_torch import harness

    overrides = {}
    if args.model_path:
        overrides["model_path"] = args.model_path
    if args.model_architecture:
        overrides["architecture"] = args.model_architecture
    if args.num_ctx_tokens:
        overrides["context_size"] = args.num_ctx_tokens

    # without --config, start from an empty config (determinism-only
    # defaults): the tiny models' goldens in test_configs/ must never apply
    # to a user's real checkpoint
    cfg = {}
    arch = args.model_architecture
    if args.config:
        cfg_path = Path(args.config)
        cfg = _json.loads(cfg_path.read_text())
        arch = arch or cfg.get("architecture") or cfg_path.stem
    if not arch:
        raise SystemExit("verify: pass -a/--model-architecture or --config "
                         "with an 'architecture' key")

    extra = []
    if args.ppl_corpus:
        case = {"corpus": args.ppl_corpus, "tolerance": args.ppl_tolerance}
        if args.ppl_expected is not None:
            case["expected"] = args.ppl_expected
        extra.append({"Perplexity": case})

    record = bool(args.record)
    if record:
        cfg.setdefault("architecture", arch)
        if not (overrides.get("model_path") or cfg.get("model_path")
                or cfg.get("url")):
            raise SystemExit(
                "verify --record: needs a local checkpoint (-m) or a "
                "--config with a model_path/url"
            )

    report = harness.run_arch(arch, harness.DEFAULT_CONFIG_DIR,
                              overrides=overrides, extra_cases=extra,
                              config=cfg, record=record, device=args.device)
    ok = report.status == "ok" and all(
        c.status == "passed" for c in report.cases
    )
    for c in report.cases:
        line = f"  {c.name}: {c.status}"
        if c.message:
            line += f" ({c.message})"
        print(line)
    if report.error:
        print(report.error.splitlines()[0], file=sys.stderr)
    if record and ok and report.recorded is not None:
        out_path = Path(
            args.record_out or args.config
            or harness.DEFAULT_CONFIG_DIR / "real" / f"{arch}.recorded.json"
        )
        if args.model_path and args.config and cfg.get("url"):
            # -m overrode a url-pinned config: the url stays canonical and
            # this machine's local path stays out of the shared file
            report.recorded.pop("model_path", None)
        out_path.write_text(_json.dumps(report.recorded, indent=2) + "\n")
        print(f"recorded goldens -> {out_path}")
    print("PASS" if ok else "FAIL")
    if not ok:
        raise SystemExit(1)


def cmd_info(args) -> None:
    from llm_tpu_torch.ggml.gguf import GgufReader, is_gguf
    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.models.spec import get_arch

    if is_gguf(args.model_path):
        reader = GgufReader(args.model_path).load(args.model_architecture)
    else:
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


def cmd_prompt_tokens(args) -> None:
    prompt = resolve_prompt(args)
    model = load_model(args)
    toks = model.tokenizer.tokenize(prompt, False)
    print("=== Dumping prompt tokens:")
    print(", ".join(str(tid) for _, tid in toks))
    print(
        ", ".join(
            f"{tok.decode('utf-8', errors='replace')!r}:{tid}"
            for tok, tid in toks
        )
    )


def cmd_repl(args) -> None:
    """A fresh session for each line."""
    from llm_tpu_torch import session as S

    model = load_model(args)
    config = session_config(args, model)
    params = inference_parameters(args, model)
    template = None
    if args.prompt_file:
        template = Path(args.prompt_file).read_text().rstrip("\n")

    print(">> ", end="", flush=True)
    pending: list[str] = []
    for line in sys.stdin:
        line = line.rstrip("\n")
        if line.endswith("\\"):
            # rustyline-style line continuation
            pending.append(line[:-1])
            print(".. ", end="", flush=True)
            continue
        if pending:
            line = "\n".join(pending + [line])
            pending = []
        if not line:
            print(">> ", end="", flush=True)
            continue
        prompt = template.replace("{{PROMPT}}", line) if template else line
        sess = S.InferenceSession(model, config)
        rng = np.random.default_rng(args.seed)

        def callback(r):
            if r.kind == "inferred_token":
                _print_token(r.text)
            return S.InferenceFeedback.Continue

        try:
            sess.infer(
                S.InferenceRequest(
                    prompt=prompt,
                    parameters=params,
                    maximum_token_count=args.num_predict,
                ),
                rng=rng,
                callback=callback,
            )
        except S.ContextFull:
            print("Context window full.", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 (a bad line keeps the repl)
            print(f"error: {e}", file=sys.stderr)
        print()
        print(">> ", end="", flush=True)


def cmd_chat(args) -> None:
    """A prelude, then a prefix before each message; the prefix is also
    the stop sequence."""
    from llm_tpu_torch import session as S
    from llm_tpu_torch.tokenizer import TokenUtf8Buffer

    model = load_model(args)
    config = session_config(args, model)
    params = inference_parameters(args, model)

    prelude = Path(args.prelude_prompt_file).read_text()
    if args.message_prompt_prefix and args.message_prompt_prefix_file:
        _err("cannot specify both --message-prompt-prefix and "
             "--message-prompt-prefix-file")
    if args.message_prompt_prefix_file:
        prefix = Path(args.message_prompt_prefix_file).read_text().rstrip(
            "\n")
    elif args.message_prompt_prefix:
        prefix = args.message_prompt_prefix
    else:
        _err("a message prompt prefix is required")

    sess = S.InferenceSession(model, config)
    sess.feed_prompt(prelude)
    stop_sequence = prefix.strip()

    print(">> ", end="", flush=True)
    for line in sys.stdin:
        line = line.rstrip("\n")
        rng = np.random.default_rng(args.seed)
        try:
            sess.feed_prompt(f"{prefix}{line}")
            cb = S.conversation_inference_callback(stop_sequence,
                                                   _print_token)
            utf8 = TokenUtf8Buffer()  # a character split over tokens
            while True:
                try:
                    token = sess.infer_next_token(rng, params)
                except (S.EndOfText, S.ContextFull):
                    break
                piece = utf8.push(token)
                if not piece:
                    continue
                resp = S.InferenceResponse("inferred_token", piece)
                if cb(resp) is S.InferenceFeedback.Halt:
                    break
        except S.ContextFull:
            print("Context window full.", file=sys.stderr)
        print()
        print(">> ", end="", flush=True)


def cmd_gguf_convert(args) -> None:
    from llm_tpu_torch.ggml.gguf import convert_ggml_to_gguf

    tmpl = args.chat_template
    if tmpl and os.path.exists(tmpl):
        tmpl = Path(tmpl).read_text()
    convert_ggml_to_gguf(
        args.source, args.destination, args.model_architecture,
        tokenizer_json=args.tokenizer_json, chat_template=tmpl,
    )
    print(f"wrote {args.destination}", file=sys.stderr)


def cmd_serve(args) -> None:
    """HTTP serving over the continuous-batching engine (dense or paged;
    with --multihost one rank of a world, `parallel/multihost.py`)."""
    # pure-argument validation BEFORE the world and the multi-GB load
    if args.kv_int4 and not args.paged:
        raise SystemExit("--kv-int4 requires --paged (pool-only format)")
    if args.kv_int4 and args.kv_int8:
        raise SystemExit("--kv-int4 and --kv-int8 conflict; pick one")
    if args.prefix_cache and (args.multihost or not args.paged):
        raise SystemExit("--prefix-cache requires --paged (single-host)")
    if args.multihost and args.draft_model:
        raise SystemExit("--draft-model with --multihost: not yet")
    if args.multihost:
        # join the world before the model loads: under nccl this picks
        # the rank's card
        from llm_tpu_torch.parallel.multihost import initialize

        initialize(args.coordinator, args.num_processes, args.process_id,
                   device=args.device)
    try:
        _serve(args)
    finally:
        if args.multihost:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _serve(args) -> None:
    import torch

    from llm_tpu_torch.server import serve_forever

    model = load_model(args)
    draft = load_draft(args) if args.draft_model else None
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
            draft=draft,
            draft_k=args.draft_k,
            draft_sampled=args.draft_sampled,
            engine_snapshot=args.engine_snapshot,
            multihost=args.multihost,
            model_parallel=args.model_parallel,
        )
    except KeyboardInterrupt:
        pass


def cmd_convert_hf(args) -> None:
    from llm_tpu_torch.convert_hf import convert_hf

    arch = convert_hf(
        args.source,
        args.destination,
        architecture=args.model_architecture,
        ftype=args.ftype,
        gguf=args.gguf,
        tokenizer_json=args.tokenizer_json,
        progress=lambda name: print(f"  {name}", file=sys.stderr),
    )
    print(f"wrote {args.destination} ({arch}, {args.ftype})", file=sys.stderr)


def cmd_quantize(args) -> None:
    from llm_tpu_torch.ggml.types import ContainerType, GgmlType
    from llm_tpu_torch.quantize import QuantizeError, quantize

    if not args.model_architecture:
        _err("the architecture must be known for quantization")
    target = GgmlType[args.target.upper()]
    if args.container_type == "ggml":
        container = ContainerType("ggml")
    elif args.container_type == "gguf" or (
        args.container_type == "ggjt-v3"
        and str(args.destination).endswith(".gguf")
    ):
        container = ContainerType("gguf", 3)
    else:
        container = ContainerType("ggjt", 3)

    def progress(ev):
        if ev.kind == "tensor_quantized":
            print(
                f"Quantized tensor `{ev.name}` from {ev.original_size} to "
                f"{ev.reduced_size} bytes",
                file=sys.stderr,
            )
        elif ev.kind == "tensor_skipped":
            print(f"Skipped tensor `{ev.name}`", file=sys.stderr)
        elif ev.kind == "finished":
            print(
                f"Finished quantization from {ev.original_size} to "
                f"{ev.reduced_size} bytes "
                f"({[] if ev.history is None else list(ev.history)})",
                file=sys.stderr,
            )

    try:
        quantize(
            args.source,
            args.destination,
            args.model_architecture,
            target,
            container=container,
            progress=progress,
        )
    except QuantizeError as e:
        _err(str(e))


def cmd_pack(args) -> None:
    """Build the packed planes once and cache them on disk; later loads of
    the same file skip the transcode (models/pack_cache.py)."""
    import time as _time

    from llm_tpu_torch.models.pack_cache import (
        cache_key, pack_path, save_packed_params,
    )

    if args.lora_paths:
        # the key does not name the adapters, so a later plain load would
        # read the patched planes as the file's own
        raise SystemExit("pack: --lora-paths is not packed; LoRA loads "
                         "bypass the pack cache")
    t0 = _time.monotonic()
    model = load_model(args)
    pp = pack_path(args.model_path)
    save_packed_params(
        model.params, pp,
        cache_key(args.model_path, n_gqa=getattr(args, "n_gqa", None)),
    )
    print(
        f"packed {args.model_path} -> {pp} "
        f"in {_time.monotonic() - t0:.1f}s",
        file=sys.stderr,
    )


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
    p.add_argument("--load-session", default=None)
    p.add_argument("--save-session", default=None)
    p.add_argument("--persist-session", default=None)
    p.add_argument("--stats", action="store_true")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("perplexity", help="measure perplexity over a prompt")
    add_model_args(p)
    add_load_args(p)
    add_generate_args(p)
    add_prompt_args(p)
    p.set_defaults(fn=cmd_perplexity)

    p = sub.add_parser("info", help="dump model metadata")
    add_model_args(p)
    p.add_argument("-t", "--tensors", action="store_true")
    p.add_argument("-k", "--tokenizer", action="store_true")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "verify",
        help="run the llm-test golden cases (+ an optional perplexity "
        "gate) against a local checkpoint",
    )
    p.add_argument("-m", "--model-path", default=None,
                   help="path to the model file (overrides --config)")
    p.add_argument("-a", "--model-architecture", default=None)
    p.add_argument("--config", default=None,
                   help="llm-test style JSON with goldens/url/sha256 "
                   "(see test_configs/real/)")
    p.add_argument("--num-ctx-tokens", type=int, default=None)
    p.add_argument("--ppl-corpus", default=None,
                   help="text file (e.g. wikitext-2 wiki.test.raw) for the "
                   "perplexity gate")
    p.add_argument("--ppl-expected", type=float, default=None,
                   help="reference PPL; ours must be <= expected + tolerance")
    p.add_argument("--ppl-tolerance", type=float, default=0.1)
    p.add_argument("--record", action="store_true",
                   help="record the observed goldens (Tokens argmax, greedy "
                   "Inference text, measured PPL) and the file's sha256 "
                   "into the config instead of asserting them")
    p.add_argument("--record-out", default=None,
                   help="where to write the recorded config (default: the "
                   "--config path, or test_configs/real/<arch>.recorded.json)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser(
        "pack",
        help="write a pre-packed plane cache next to the checkpoint so "
        "later loads skip the block transcode",
    )
    add_model_args(p)
    add_load_args(p)
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("prompt-tokens", help="print the token ids of a prompt")
    add_model_args(p)
    add_load_args(p)
    add_prompt_args(p)
    p.set_defaults(fn=cmd_prompt_tokens)

    p = sub.add_parser("repl", help="interactive REPL (fresh session per line)")
    add_model_args(p)
    add_load_args(p)
    add_generate_args(p)
    p.add_argument("-f", "--prompt-file", default=None,
                   help="template file; {{PROMPT}} is replaced per line")
    p.set_defaults(fn=cmd_repl)

    p = sub.add_parser("chat", help="chat with a model")
    add_model_args(p)
    add_load_args(p)
    add_generate_args(p)
    p.add_argument("-f", "--prelude-prompt-file", required=True)
    p.add_argument("-p", "--message-prompt-prefix", default=None)
    p.add_argument("-q", "--message-prompt-prefix-file", default=None)
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser(
        "gguf-convert",
        help="convert a classic GGML/GGJT checkpoint to GGUF v3",
    )
    p.add_argument("source")
    p.add_argument("destination")
    p.add_argument("-a", "--model-architecture", required=True)
    p.add_argument(
        "--tokenizer-json", default=None,
        help="HF tokenizer.json to source BPE merges from "
        "(emits tokenizer.ggml.merges / model=gpt2)",
    )
    p.add_argument(
        "--chat-template", default=None,
        help="HF-convention jinja chat template to embed as "
        "tokenizer.chat_template (file path or literal template text)",
    )
    p.set_defaults(fn=cmd_gguf_convert)

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
    p.add_argument("--draft-model", default=None,
                   help="speculative decoding: small same-vocabulary draft "
                   "checkpoint, loaded on the same device and context "
                   "(greedy requests only; dense KV, or paged with --paged "
                   "incl. --prefix-cache/--kv-int8; not with --multihost)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="draft proposals per speculative round")
    p.add_argument("--draft-sampled", action="store_true",
                   help="rejection-sampling speculative decoding: serves "
                   "SAMPLED requests (temperature/top-k/top-p/min-p; "
                   "greedy maps to top-k 1) with the output distribution "
                   "exactly the target's")
    p.add_argument("--multihost", action="store_true",
                   help="serve across processes over the world's mesh, one "
                   "process a card (run one `serve` a rank; each row's "
                   "leader binds --port; --max-streams counts the world's "
                   "slots)")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's store address host:port (tcp://); "
                   "default: torch's MASTER_ADDR/MASTER_PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=None,
                   help="TP width (default: the ranks on this node, so TP "
                   "collectives stay on the node's links)")
    p.add_argument("--engine-snapshot", default=None,
                   help="engine checkpoint/resume path: restored at "
                   "startup if present, written on graceful shutdown, and "
                   "written live by POST /admin/checkpoint (multi-host: "
                   "one .host<N> file a rank, no live checkpoint)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "convert-hf",
        help="convert a HuggingFace checkpoint directory to GGML/GGUF",
    )
    p.add_argument("source", help="HF model directory (from_pretrained "
                   "path; needs the transformers package)")
    p.add_argument("destination", help="output checkpoint path")
    p.add_argument("-a", "--model-architecture", default=None,
                   help="override the architecture detected from config.json")
    p.add_argument("--ftype", choices=["f32", "f16"], default="f16",
                   help="storage type for 2-D weights (default f16)")
    p.add_argument("--gguf", action="store_true",
                   help="write GGUF v3 instead of classic GGJT v3")
    p.add_argument("--tokenizer-json", default=None,
                   help="tokenizer.json to embed BPE merges from (GGUF only)")
    p.set_defaults(fn=cmd_convert_hf)

    p = sub.add_parser("quantize", help="quantize a model to a block format")
    p.add_argument("-a", "--model-architecture", default=None,
                   help="model architecture")
    p.add_argument("-v", "--tokenizer-path", default=None)
    p.add_argument("-r", "--tokenizer-repository", default=None)
    p.add_argument("source", help="the file to quantize")
    p.add_argument("destination",
                   help="the file to write the quantized model to")
    p.add_argument("-c", "--container-type",
                   choices=["ggml", "ggjt-v3", "gguf"], default="ggjt-v3")
    p.add_argument("target",
                   choices=["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                            # an extension: the reference's quantize.rs
                            # takes the scalar formats only
                            "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"])
    p.set_defaults(fn=cmd_quantize)
    return parser


def main(argv: Optional[list[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
