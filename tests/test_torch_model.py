"""The port as a whole against the JAX package, on a tiny LLaMA checkpoint
written by the JAX package's `make_tiny_file`: weight carry and loading,
forward logits (prefill with both attention branches, decode), greedy
`infer` through the session and through the CLI, and the port's import
boundary.

Tolerance for logits: atol = rtol = 1e-5. Both packages run f32 on the
CPU (the bf16/int8 cache rounds identical values identically); the sums
run in another order (torch vs XLA, and T=1 attention through the port's
online pass against the reference's materialized softmax), which moves
logits of magnitude ~0.2 by a few 1e-8. Greedy tokens and text must be
identical."""

import ast
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu import session as jsession
from llm_tpu.cli import main as j_main
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops.packing import QuantTensor as JQuantTensor
from llm_tpu.ops.packing import QuantTensorC
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import session as tsession
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.models.params import LayerParams, params_from_numpy
from llm_tpu_torch.ops.packing import QuantTensor
from llm_tpu_torch.samplers import build_sampler_chain as t_chain

REPO = Path(__file__).resolve().parent.parent
CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": ("int8", "int8")}


@pytest.fixture(scope="module", params=[GgmlType.Q4_0, GgmlType.Q5_1],
                ids=["q4_0", "q5_1"])
def models(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_model") / "llama.bin"
    make_tiny_file("llama", path, request.param)
    jm = j_load(path, "llama", params=JModelParameters(context_size=CTX))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    return path, jm, tm


# -- weights ---------------------------------------------------------------


def _leaf_to_numpy(v):
    """One leaf of the JAX params as the port's weight carry takes it: a
    coalesced weight as its buffer, planes as planes."""
    if v is None:
        return None
    if isinstance(v, QuantTensorC):
        return {
            "fmt_name": v.fmt_name, "k": v.k, "r": v.r, "kp": v.kp,
            "rp": v.rp, "tile_k": v.tile_k, "tile_r": v.tile_r,
            "scale_packed": v.scale_packed, "splits": v.splits,
            "buf": np.asarray(v.buf),
        }
    if isinstance(v, JQuantTensor):
        return {
            "fmt_name": v.fmt_name, "k": v.k, "r": v.r, "splits": v.splits,
            **{n: None if getattr(v, n) is None else np.asarray(getattr(v, n))
               for n in ("lo", "hi", "scale", "bias")},
        }
    return np.asarray(v)


def jax_params_tree(jp) -> dict:
    tree = {f.name: _leaf_to_numpy(getattr(jp, f.name))
            for f in fields(jp) if f.name != "layers"}
    tree["layers"] = {f.name: _leaf_to_numpy(getattr(jp.layers, f.name))
                      for f in fields(jp.layers)}
    return tree


def _assert_weight_equal(a, b, name):
    assert type(a) is type(b), name
    if a is None:
        return
    if isinstance(a, QuantTensor):
        assert (a.fmt_name, a.k, a.r, a.splits) == \
            (b.fmt_name, b.k, b.r, b.splits), name
        for p in ("lo", "hi", "scale", "bias"):
            x, y = getattr(a, p), getattr(b, p)
            assert (x is None) == (y is None), f"{name}.{p}"
            if x is not None:
                assert x.dtype == y.dtype, f"{name}.{p}"
                assert torch.equal(x, y), f"{name}.{p}"
        return
    assert a.dtype == b.dtype and torch.equal(a, b), name


def test_carried_params_equal_loaded(models):
    _, jm, tm = models
    carried = params_from_numpy(jax_params_tree(jm.params), "cpu")
    assert tm.params.layers.w_qkv is not None  # fused as the reference is
    assert tm.params.layers.w_gate_up is not None
    for f in fields(LayerParams):
        _assert_weight_equal(getattr(carried.layers, f.name),
                             getattr(tm.params.layers, f.name), f.name)
    for f in fields(tm.params):
        if f.name != "layers":
            _assert_weight_equal(getattr(carried, f.name),
                                 getattr(tm.params, f.name), f.name)


def test_load_defaults_to_cuda(models, monkeypatch):
    path = models[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloader.load(path, "llama")


# -- forward ---------------------------------------------------------------


def _steps(fwd, model, kv_dtype, chunks, as_ids):
    """Logits of consecutive forward_step calls from an empty cache."""
    cache = fwd.init_cache(model.spec, kv_dtype)
    n_past, out = 0, []
    for ids in chunks:
        logits, _, cache = fwd.forward_step(model.spec, model.params,
                                            as_ids(ids), n_past, cache)
        out.append(np.asarray(logits, np.float32))
        n_past += len(ids)
    return out


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("online", [False, True], ids=["materialized",
                                                       "online"])
def test_forward_step_logits_match(models, monkeypatch, kv, online):
    _, jm, tm = models
    if online:  # force the block-wise online prefill branch in both
        for fwd in (jfwd, tfwd):
            monkeypatch.setattr(fwd, "_ONLINE_MIN_SCORE_BYTES", 0)
            monkeypatch.setattr(fwd, "_KV_BLOCK", 16)
    rng = np.random.default_rng(7)
    chunks = [rng.integers(1, 96, n).tolist() for n in (21, 11, 1, 1)]
    ref = _steps(jfwd, jm, KV[kv][0], chunks,
                 lambda ids: jnp.asarray(ids, jnp.int32))
    got = _steps(tfwd, tm, KV[kv][1], chunks, torch.tensor)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **TOL)


# -- session and CLI -------------------------------------------------------


def _greedy_infer(session_mod, model, chain, prompt, n):
    sess = session_mod.InferenceSession(model,
                                        session_mod.InferenceSessionConfig())
    texts = []

    def cb(r):
        if r.kind == "inferred_token":
            texts.append(r.text)
        return session_mod.InferenceFeedback.Continue

    req = session_mod.InferenceRequest(
        prompt=prompt, maximum_token_count=n,
        parameters=session_mod.InferenceParameters(sampler=chain))
    sess.infer(req, rng=np.random.default_rng(0), callback=cb)
    return sess.tokens, "".join(texts)


def test_greedy_infer_same_tokens_and_text(models):
    _, jm, tm = models
    eot = [(0, float("-inf"))]
    prompt = list(np.random.default_rng(3).integers(1, 96, 19))
    jt, jtext = _greedy_infer(jsession, jm, j_chain(["topk:k=1"], bias=eot),
                              prompt, 12)
    tt, ttext = _greedy_infer(tsession, tm, t_chain(["topk:k=1"], bias=eot),
                              prompt, 12)
    assert len(tt) == 19 + 12
    assert tt == jt
    assert ttext == jtext and ttext


def test_cli_infer_same_greedy_text(models, capsys):
    path = models[0]
    argv = ["infer", "-m", str(path), "-a", "llama", "-p", "<t2><t3><t9>",
            "-n", "6", "--seed", "3", "-s", "topk:k=1", "--ignore-eos",
            "--num-ctx-tokens", str(CTX)]
    j_main(argv)
    ref = capsys.readouterr().out
    t_main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref
    prompt_end = got.index("<t2><t3><t9>") + len("<t2><t3><t9>")
    assert got[prompt_end:].count("<t") == 6  # six generated tokens


def test_cli_info(models, capsys):
    t_main(["info", "-m", str(models[0]), "-a", "llama", "-t"])
    out = capsys.readouterr().out
    assert "Tokenizer vocabulary size: 96" in out
    assert "tok_embeddings.weight" in out


# -- import boundary -------------------------------------------------------


def test_port_imports_no_jax_and_no_reference_package():
    pkg = REPO / "llm_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    modules = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "llm_tpu"), (f, n)
        if f.parent.name != "csrc" and f.name != "__main__.py":
            rel = f.relative_to(REPO).with_suffix("")
            if rel.parts[0] == "llm_tpu_torch":
                modules.append(".".join(rel.parts).removesuffix(".__init__"))
    assert {"llm_tpu_torch.ops.paged_attention", "llm_tpu_torch.paged",
            "llm_tpu_torch.serve", "llm_tpu_torch.server",
            "llm_tpu_torch.ops.qmatmul_probe", "llm_tpu_torch.probes",
            "llm_tpu_torch.probes.common", "llm_tpu_torch.probes.coalesced",
            "llm_tpu_torch.probes.kernel_decompose",
            "llm_tpu_torch.probes.dequant_variants",
            "llm_tpu_torch.ops.sampling", "llm_tpu_torch.ggml.gguf",
            "llm_tpu_torch.tokenizer.bpe", "llm_tpu_torch.snapshot",
            "llm_tpu_torch.harness", "llm_tpu_torch.speculative",
            "llm_tpu_torch.lora", "llm_tpu_torch.quantize",
            "llm_tpu_torch.convert_hf", "llm_tpu_torch.engine_snapshot",
            "llm_tpu_torch.native"} \
        <= set(modules)
    # importing every module of the port loads neither package
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'llm_tpu')]\n"
            + "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
