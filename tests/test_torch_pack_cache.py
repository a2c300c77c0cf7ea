"""The port's pack cache (llm_tpu_torch.models.pack_cache, the loader's
hook and `llm-tpu-torch pack`), mirroring tests/test_pack_cache.py on tiny
files: a warm load's planes and logits equal the cold load's bit for bit
(and the JAX package's warm load within 1e-5, both f32 on the CPU),
`QuantTensorC` and bf16 leaves round-trip bit for bit, touching the file
or a corrupt manifest falls back to the transcode, and LoRA loads bypass
the cache. Beyond the reference's: the directory is `<model>.torchpack`,
a `.tpupack` beside the file is never read, `pack --lora-paths` is
refused, and the dense-upcast knobs are part of the key (the JAX package's key leaves them out, so its warm
load keeps the planes when the upcast is asked for)."""

import os
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.loader as jloader
import llm_tpu.models.forward as jfwd
import llm_tpu.models.pack_cache as jpack
import llm_tpu_torch.loader as tloader
import llm_tpu_torch.models.forward as tfwd
from llm_tpu.ggml.types import GgmlType
from llm_tpu.ops.packing import QuantTensor as JQuantTensor
from llm_tpu.ops.packing import QuantTensorC as JQuantTensorC
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.models import params as tparams
from llm_tpu_torch.models.pack_cache import (
    _load_node,
    _save_node,
    cache_key,
    load_packed_params,
    pack_path,
    save_packed_params,
)
from llm_tpu_torch.ops.packing import QuantTensor, QuantTensorC
from llm_tpu_torch.testing import make_lora_file, make_tiny_file
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

CTX = 32
IDS = [1, 2, 3]


def _load(path, arch, ctx=CTX, **kw):
    return tloader.load(path, arch,
                        params=tloader.ModelParameters(context_size=ctx, **kw),
                        device="cpu")


def _logits(model, ids=IDS):
    out, _, _ = tfwd.forward_step(model.spec, model.params, torch.tensor(ids),
                                  0, tfwd.init_cache(model.spec,
                                                     torch.float32))
    return out[-1].numpy()


def _leaves(obj, out=None):
    """Every tensor leaf of a parameter tree, in field order."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, QuantTensor):
        for p in obj.planes():
            _leaves(p, out)
    elif isinstance(obj, QuantTensorC):
        out.append(obj.buf)
    elif obj is not None and hasattr(obj, "__dataclass_fields__"):
        for f in fields(obj):
            _leaves(getattr(obj, f.name), out)
    return out


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y)


def _forbid_build(monkeypatch):
    def boom(ws, spec):
        raise AssertionError("build_params called despite a valid cache")

    monkeypatch.setattr(tparams, "build_params", boom)
    monkeypatch.setattr(tloader, "build_params", boom)


@pytest.mark.parametrize("etype", [GgmlType.F32, GgmlType.Q4_0])
def test_pack_roundtrip_bit_identical(tmp_path, monkeypatch, etype):
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, etype)
    cold = _load(path, "llama")
    ref = _logits(cold)

    save_packed_params(cold.params, pack_path(path), cache_key(path))
    _forbid_build(monkeypatch)
    warm = _load(path, "llama")
    _assert_bit_equal(warm.params, cold.params)
    np.testing.assert_array_equal(_logits(warm), ref)

    # the JAX package's warm load of its own pack agrees
    jcold = jloader.load(path, "llama",
                         params=jloader.ModelParameters(context_size=CTX))
    jpack.save_packed_params(jcold.params, jpack.pack_path(path),
                             jpack.cache_key(path))
    jwarm = jloader.load(path, "llama",
                         params=jloader.ModelParameters(context_size=CTX))
    jl, _, _ = jfwd.forward_step(jwarm.spec, jwarm.params,
                                 jnp.asarray(IDS, jnp.int32), jnp.int32(0),
                                 jfwd.init_cache(jwarm.spec, jnp.float32))
    np.testing.assert_allclose(_logits(warm), np.asarray(jl)[-1],
                               rtol=1e-5, atol=1e-5)


def test_pack_cli_and_key_invalidation(tmp_path, capsys):
    path = tmp_path / "m.bin"
    make_tiny_file("gpt2", path, GgmlType.Q8_0)
    t_main(["pack", "-m", str(path), "-a", "gpt2", "--device", "cpu"])
    assert "packed" in capsys.readouterr().err
    pp = pack_path(path)
    assert (pp / "manifest.json").exists()
    assert load_packed_params(pp, cache_key(path)) is not None

    # touching the checkpoint invalidates the cache: the recomputed key no
    # longer matches
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    assert load_packed_params(pp, cache_key(path)) is None
    # and a full load still succeeds (falls back to the transcode)
    assert _load(path, "gpt2").params is not None


def test_pack_corrupt_manifest_ignored(tmp_path):
    path = tmp_path / "m.bin"
    make_tiny_file("mpt", path, GgmlType.Q4_0)
    cold = _load(path, "mpt")
    ref = _logits(cold)
    pp = pack_path(path)
    save_packed_params(cold.params, pp, cache_key(path))
    (pp / "manifest.json").write_text("{not json")
    warm = _load(path, "mpt")
    np.testing.assert_array_equal(_logits(warm), ref)


def test_pack_bf16_leaf_roundtrip(tmp_path):
    a = torch.arange(8, dtype=torch.bfloat16) / 3
    arrays = []
    spec = _save_node(a, arrays, [0])
    for fname, arr in arrays:
        np.save(tmp_path / fname, arr)
    back = _load_node(spec, tmp_path, "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), a.view(torch.int16))


def test_pack_lora_bypasses_cache(tmp_path):
    """A LoRA load must not use the (unpatched) cache."""
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path)
    base = _load(path, "llama")
    save_packed_params(base.params, pack_path(path), cache_key(path))
    lora = tmp_path / "adapter.ggla"
    name = "layers.0.attention.wq.weight"
    make_lora_file(lora, [name], {name: (64, 64)}, r=4, alpha=8)
    patched = _load(path, "llama", lora_adapters=[str(lora)])
    assert not np.array_equal(_logits(patched), _logits(base))


def test_pack_cli_refuses_lora(tmp_path):
    """`pack --lora-paths` writes nothing, so a later plain load never
    reads patched planes under the file's key (the JAX package's `pack`
    writes them)."""
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path)
    base = _load(path, "llama")
    lora = tmp_path / "adapter.ggla"
    name = "layers.0.attention.wq.weight"
    make_lora_file(lora, [name], {name: (64, 64)}, r=4, alpha=8)
    with pytest.raises(SystemExit, match="lora-paths"):
        t_main(["pack", "-m", str(path), "-a", "llama", "--device", "cpu",
                "--lora-paths", str(lora)])
    assert not pack_path(path).exists()
    np.testing.assert_array_equal(_logits(_load(path, "llama")),
                                  _logits(base))


def test_pack_roundtrip_coalesced(tmp_path):
    """quantc nodes (the coalesced layout) save and reload bit for bit,
    and the reloaded model's logits equal the saved one's."""
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, element_type=GgmlType.Q4_0,
                   n_embd=512, n_head=8)
    m1 = _load(path, "llama", ctx=64)
    c = tparams.coalesce_layer_weights(m1.params, min_k=0)
    assert isinstance(c.layers.w_gate_up, QuantTensorC)
    key = cache_key(path)
    save_packed_params(c, pack_path(path), key)
    loaded = load_packed_params(pack_path(path), key)
    assert isinstance(loaded.layers.w_gate_up, QuantTensorC)
    _assert_bit_equal(loaded, c)
    m1.params = loaded
    ref = _logits(m1)
    m1.params = c
    np.testing.assert_array_equal(_logits(m1), ref)


def test_pack_directory_name(tmp_path):
    path = tmp_path / "m.bin"
    assert pack_path(path) == tmp_path / "m.bin.torchpack"
    assert pack_path(path) != jpack.pack_path(path)


def test_reference_pack_never_read(tmp_path, monkeypatch):
    """A `.tpupack` beside the file (the JAX package's planes) is not a
    port cache: the port's load transcodes and equals its cold load."""
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jcold = jloader.load(path, "llama",
                         params=jloader.ModelParameters(context_size=CTX))
    jpack.save_packed_params(jcold.params, jpack.pack_path(path),
                             jpack.cache_key(path))
    assert not pack_path(path).exists()
    calls = []
    build = tloader.build_params
    monkeypatch.setattr(tloader, "build_params",
                        lambda ws, spec: calls.append(1) or build(ws, spec))
    warm = _load(path, "llama")
    assert calls == [1]
    monkeypatch.setenv("LLM_TPU_PACK_CACHE", "0")
    _assert_bit_equal(warm.params, _load(path, "llama").params)


def test_pack_cache_env_off(tmp_path, monkeypatch):
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    cold = _load(path, "llama")
    save_packed_params(cold.params, pack_path(path), cache_key(path))
    monkeypatch.setenv("LLM_TPU_PACK_CACHE", "0")
    calls = []
    build = tloader.build_params
    monkeypatch.setattr(tloader, "build_params",
                        lambda ws, spec: calls.append(1) or build(ws, spec))
    _load(path, "llama")
    assert calls == [1]


@pytest.mark.parametrize("env", [
    {"LLM_TPU_DENSE_UPCAST": "1"},
    {"LLM_TPU_DENSE_UPCAST": "auto", "LLM_TPU_DENSE_UPCAST_MAX_MB": "1"},
])
def test_upcast_knobs_in_key(tmp_path, monkeypatch, env):
    """A pack written without the upcast is not read under it: the warm
    load is the upcast model (bf16 dense weights), as a cold load under
    the same knobs gives. The JAX package's key leaves the knobs out, so
    its pack still loads there, with the planes."""
    path = tmp_path / "m.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    plain = _load(path, "llama")
    save_packed_params(plain.params, pack_path(path), cache_key(path))
    key = cache_key(path)
    jcold = jloader.load(path, "llama",
                         params=jloader.ModelParameters(context_size=CTX))
    jpack.save_packed_params(jcold.params, jpack.pack_path(path),
                             jpack.cache_key(path))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cache_key(path) != key
    assert load_packed_params(pack_path(path), cache_key(path)) is None
    warm = _load(path, "llama")
    assert isinstance(warm.params.layers.wq, torch.Tensor)
    assert warm.params.layers.wq.dtype == torch.bfloat16
    # the reference reads its quantized pack under the same knobs
    jwarm = jpack.load_packed_params(jpack.pack_path(path),
                                     jpack.cache_key(path))
    assert isinstance(jwarm.layers.w_down, (JQuantTensor, JQuantTensorC))
