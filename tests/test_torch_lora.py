"""The port's LoRA adapters (llm_tpu_torch.lora, the loader's
`lora_adapters`) against the JAX package's (llm_tpu.lora), mirroring
tests/test_lora.py on tiny LLaMA files: the same GGLA adapter gives
byte-equal patched tensors (`LoraAdapter.patch`: dequantize, add
(B.A)*scaling, re-encode to the weight's own type) and equal patched
weights once loaded, for an f32, a Q4_0 and a Q4_K file; the patched
models' logits agree within atol = rtol = 1e-5 (both run f32 on the CPU,
the sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu.ggml.reader import GgmlReader as JGgmlReader
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.lora import LoraAdapter as JLoraAdapter
from llm_tpu.models.params import unfuse_layer_weights as j_unfuse
from llm_tpu.models.spec import get_arch as j_get_arch
from llm_tpu.ops.packing import QuantTensor as JQuantTensor
from llm_tpu.ops.packing import dequant_jnp
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.ggml.reader import GgmlReader
from llm_tpu_torch.lora import LoraAdapter
from llm_tpu_torch.models.params import unfuse_layer_weights
from llm_tpu_torch.models.spec import get_arch
from llm_tpu_torch.ops.packing import QuantTensor, dequant
from test_lora import write_ggla
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
WQ = "layers.0.attention.wq.weight"
IDS = [3, 17, 5, 9, 2]


def _adapter(tmp_path, E, r, alpha, seed, scale=1.0):
    """A GGLA file patching layer 0's wq: A numpy [K, r], B [R, r]."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((E, r)).astype(np.float32) * scale
    b = rng.standard_normal((E, r)).astype(np.float32) * scale
    path = tmp_path / "adapter.ggla"
    write_ggla(path, r, alpha, [(f"{WQ}.loraA", a), (f"{WQ}.loraB", b)])
    return path, a, b


def _load_both(path, lora=None):
    jm = j_load(path, "llama", params=JModelParameters(
        context_size=CTX, lora_adapters=lora))
    tm = tloader.load(path, "llama", params=tloader.ModelParameters(
        context_size=CTX, lora_adapters=lora), device="cpu")
    return jm, tm


def _wq(side, model, layer):
    """Layer `layer`'s wq as dense f32 numpy [K, R]."""
    if side == "jax":
        w = j_unfuse(model.params.layers).wq
        if isinstance(w, JQuantTensor):
            w = dequant_jnp(JQuantTensor(
                w.fmt_name, w.k, w.r, w.lo[layer],
                w.hi[layer] if w.hi is not None else None, w.scale[layer],
                w.bias[layer] if w.bias is not None else None))
            return np.asarray(w)
        return np.asarray(w[layer], np.float32)
    w = unfuse_layer_weights(model.params.layers).wq
    if isinstance(w, QuantTensor):
        return dequant(w.layer(layer)).numpy()
    return w[layer].to(torch.float32).numpy()


def _logits(jm, tm):
    lj, _, _ = jfwd.forward_step(
        jm.spec, jm.params, jnp.asarray(IDS, jnp.int32), jnp.int32(0),
        jfwd.init_cache(jm.spec, jnp.float32))
    lt, _, _ = tfwd.forward_step(tm.spec, tm.params, torch.tensor(IDS), 0,
                                 tfwd.init_cache(tm.spec, torch.float32))
    return np.asarray(lj), lt.numpy()


def _patch_bytes_equal(path, ggla, name):
    """The raw patched tensor of both packages' `patch`, byte for byte."""
    def read(reader_cls, arch):
        return reader_cls(path).load(
            lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f)))

    tr = read(GgmlReader, get_arch("llama"))
    jr = read(JGgmlReader, j_get_arch("llama"))
    tinfo, jinfo = tr.tensors[name], jr.tensors[name]
    got = LoraAdapter(ggla).patch(name, tinfo, tr.fetch(name))
    want = JLoraAdapter(ggla).patch(name, jinfo, jr.fetch(name))
    assert got is not None and want is not None
    assert got[0].dims == want[0].dims
    assert got[0].element_type == want[0].element_type
    assert got[1] == want[1]
    # a tensor the adapter does not name is left alone
    assert LoraAdapter(ggla).patch("norm.weight", tr.tensors["norm.weight"],
                                   tr.fetch("norm.weight")) is None


def test_lora_adapter_patch_math(tmp_path):
    path = tmp_path / "llama.bin"
    make_tiny_file("llama", path)
    E, r = 64, 4
    ggla, a, b = _adapter(tmp_path, E, r, 8, seed=0)
    adapter = LoraAdapter(ggla)
    assert adapter.scaling == 2.0
    assert adapter.tensors_to_patch == {WQ}
    _patch_bytes_equal(path, ggla, WQ)

    base_j, base_t = _load_both(path)
    jm, tm = _load_both(path, [str(ggla)])
    delta = _wq("torch", tm, 0)[:E, :E] - _wq("torch", base_t, 0)[:E, :E]
    np.testing.assert_allclose(delta, ((b @ a.T) * 2.0).T, **TOL)
    np.testing.assert_array_equal(_wq("torch", tm, 1),
                                  _wq("torch", base_t, 1))
    for layer in (0, 1):
        np.testing.assert_array_equal(_wq("torch", tm, layer),
                                      _wq("jax", jm, layer))
    lj, lt = _logits(jm, tm)
    np.testing.assert_allclose(lt, lj, **TOL)
    assert not np.allclose(_logits(base_j, base_t)[1], lt, atol=1e-3)


@pytest.mark.parametrize("fmt,n_embd,err_div", [
    (GgmlType.Q4_0, 64, 4), (GgmlType.Q4_K, 256, 8)],
    ids=["q4_0", "q4_k"])
def test_lora_patch_quantized_requantizes(tmp_path, fmt, n_embd, err_div):
    """A quantized weight is dequantized, patched and re-encoded to its
    own format: the bytes equal the reference's, the loaded planes
    dequantize equal, within the format's error of w + B.A, and the other
    layers are untouched (tests/test_lora.py's second and third tests)."""
    path = tmp_path / "llama_q.bin"
    make_tiny_file("llama", path, element_type=fmt, n_embd=n_embd)
    ggla, a, b = _adapter(tmp_path, n_embd, 2, 2, seed=1, scale=0.1)
    _patch_bytes_equal(path, ggla, WQ)

    _, base_t = _load_both(path)
    jm, tm = _load_both(path, [str(ggla)])
    assert isinstance(unfuse_layer_weights(tm.params.layers).wq, QuantTensor)
    w0, w1 = _wq("torch", base_t, 0), _wq("torch", tm, 0)
    want = w0 + (b @ a.T).T  # scaling 1.0
    assert np.abs(w1 - want).max() < np.abs(want).max() / err_div
    np.testing.assert_array_equal(_wq("torch", tm, 1),
                                  _wq("torch", base_t, 1))
    for layer in (0, 1):
        np.testing.assert_array_equal(_wq("torch", tm, layer),
                                      _wq("jax", jm, layer))
    lj, lt = _logits(jm, tm)
    np.testing.assert_allclose(lt, lj, **TOL)


def test_cli_lora_paths_infer(tmp_path, capsys):
    """`infer --lora-paths` loads the adapter: the patched model's greedy
    text equals the reference cli's on the same files."""
    from llm_tpu.cli import main as j_main
    from llm_tpu_torch.cli import main as t_main

    path = tmp_path / "llama.bin"
    make_tiny_file("llama", path, element_type=GgmlType.Q4_0)
    ggla, _, _ = _adapter(tmp_path, 64, 4, 8, seed=2, scale=2.0)
    args = ["infer", "-m", str(path), "-a", "llama", "-p", "<t2><t3>",
            "-n", "8", "-s", "topk:k=1", "--ignore-eos", "--num-ctx-tokens",
            str(CTX), "--lora-paths", str(ggla)]
    j_main(args)
    want = capsys.readouterr().out
    t_main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.count("<t") >= 8
    t_main([a for a in args if a not in ("--lora-paths", str(ggla))]
           + ["--device", "cpu"])
    assert capsys.readouterr().out != got  # the adapter changed the text


def test_make_lora_file_matches_hand_rolled_ggla(tmp_path):
    """`testing.make_lora_file` (the chip smoke test's adapter writer)
    writes the bytes of tests/test_lora.py's GGLA writer, and the adapter
    reads back its factors."""
    from llm_tpu_torch.testing import make_lora_file

    names = [WQ, "layers.1.feed_forward.w1.weight"]
    shapes = {WQ: (64, 64), names[1]: (64, 128)}
    got = tmp_path / "a.ggla"
    factors = make_lora_file(got, names, shapes, r=4, alpha=8, seed=3)
    want = tmp_path / "b.ggla"
    write_ggla(want, 4, 8, [(f"{n}.lora{x}", factors[n][i])
                            for n in names for i, x in enumerate("AB")])
    assert got.read_bytes() == want.read_bytes()
    adapter = LoraAdapter(got)
    assert adapter.tensors_to_patch == set(names)
    np.testing.assert_array_equal(adapter._dense(f"{names[1]}.loraB"),
                                  factors[names[1]][1])
    assert factors[names[1]][1].shape == (128, 4)
