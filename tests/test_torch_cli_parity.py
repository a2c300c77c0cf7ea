"""The port's command line against the JAX package's `build_parser()`:
every subcommand the two share takes the same options, in the same
argument groups, with the same defaults and actions. The planned
difference is listed by name, and any other gap fails:

- `--device` (the port's own: the torch device, default the card).

Serve's multi-host flags (`--multihost`, `--coordinator`,
`--num-processes`, `--process-id`, `--model-parallel`) are the
reference's.

A session saved with `-t 4` writes the same header bytes in both packages
(the reference records the thread count in the snapshot header)."""

import argparse
import json
import struct

import pytest

from llm_tpu.cli import build_parser as j_build_parser
from llm_tpu.cli import main as j_main
from llm_tpu.ggml.types import GgmlType
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch.cli import build_parser, main as t_main
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

PORT_ONLY = {"--device"}
REFERENCE_ONLY_COMMANDS: set = set()
REFERENCE_ONLY: dict = {}


def _commands(parser) -> dict:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return dict(sub.choices)


def _options(p: argparse.ArgumentParser) -> dict:
    """Each option by its longest flag: (its flags, dest, default, nargs,
    action class, argument group title); positionals by dest."""
    groups = {}
    for g in p._action_groups:
        for a in g._group_actions:
            groups[id(a)] = g.title
    out = {}
    for a in p._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = max(a.option_strings, key=len) if a.option_strings else a.dest
        out[key] = (tuple(sorted(a.option_strings)), a.dest, a.default,
                    a.nargs, type(a).__name__, groups[id(a)],
                    tuple(a.choices) if a.choices else None)
    return out


def test_subcommands():
    port, ref = _commands(build_parser()), _commands(j_build_parser())
    assert set(ref) - set(port) == REFERENCE_ONLY_COMMANDS
    assert set(port) <= set(ref)


@pytest.mark.parametrize("command", sorted(
    set(_commands(j_build_parser())) - REFERENCE_ONLY_COMMANDS))
def test_options_match_reference(command):
    port = _options(_commands(build_parser())[command])
    ref = _options(_commands(j_build_parser())[command])
    assert set(port) - set(ref) <= PORT_ONLY
    assert set(ref) - set(port) == REFERENCE_ONLY.get(command, set())
    for key in set(port) & set(ref):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("flags", [
    ["--no-mmap"], ["--gpu-layers", "10"], ["-t", "8"],
    ["--num-threads", "2"], ["--use-gpu"], ["--lora-paths"]])
def test_parity_flags_parse(flags):
    """The flags the reference accepts for parity parse in the port (they
    failed with exit 2 before)."""
    args = ["infer", "-m", "x.bin", "-a", "llama", *flags]
    got = build_parser().parse_args(args)
    want = j_build_parser().parse_args(args)
    for name in ("no_mmap", "gpu_layers", "num_threads", "use_gpu",
                 "lora_paths"):
        assert getattr(got, name) == getattr(want, name)


def test_session_header_records_threads(tmp_path, capsys):
    path = tmp_path / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    headers = {}
    for side, main, extra in (("jax", j_main, []),
                              ("torch", t_main, ["--device", "cpu"])):
        sess = tmp_path / f"{side}.session"
        main(["infer", "-m", str(path), "-a", "llama", "-p", "<t2><t3>",
              "-n", "3", "-s", "topk:k=1", "--ignore-eos",
              "--num-ctx-tokens", "64", "-t", "4", "--save-session",
              str(sess), *extra])
        capsys.readouterr()
        raw = sess.read_bytes()
        (hlen,) = struct.unpack("<I", raw[9:13])
        headers[side] = raw[13:13 + hlen]
    assert headers["torch"] == headers["jax"]
    assert json.loads(headers["torch"])["n_threads"] == 4
