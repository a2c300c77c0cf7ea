"""The port's dense upcast (llm_tpu_torch.models.params.upcast_model_weights
and maybe_upcast_dense, the loader's LLM_TPU_DENSE_UPCAST gate) against the
JAX package's, mirroring tests/test_dense_upcast.py on tiny Q4_0 files:
with an f32 upcast the logits equal the quantized model's and the
reference's upcast model's within atol = rtol = 1e-5 (both run f32 on the
CPU, the sums in another order); each layer's dense weight equals the
reference's `dequant_jnp` bit for bit; fused q|k|v and gate|up are
unfused first; the gate is off by default, "auto" and any unknown value
upcast to bf16 under LLM_TPU_DENSE_UPCAST_MAX_MB, and the size sum leaves
out `wpe`, as the reference's does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.models.forward as jfwd
import llm_tpu.models.params as jparams
import llm_tpu_torch.models.forward as tfwd
import llm_tpu_torch.models.params as tparams
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops.packing import QuantTensor as JQuantTensor
from llm_tpu.ops.packing import dequant_jnp
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.ops import qmatmul as tqm
from llm_tpu_torch.ops.packing import QuantTensor
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
IDS = [3, 17, 5, 9]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_upcast")
    out = {}
    for arch in ("llama", "gpt2"):
        out[arch] = d / f"{arch}.bin"
        make_tiny_file(arch, out[arch], element_type=GgmlType.Q4_0)
    return out


def _load(path, arch, side):
    if side == "jax":
        return j_load(path, arch, params=JModelParameters(context_size=CTX))
    return tloader.load(path, arch,
                        params=tloader.ModelParameters(context_size=CTX),
                        device="cpu")


def _t_logits(model, params):
    out, _, _ = tfwd.forward_step(model.spec, params, torch.tensor(IDS), 0,
                                  tfwd.init_cache(model.spec, torch.float32))
    return out.numpy()


def _j_logits(model, params):
    out, _, _ = jfwd.forward_step(
        model.spec, params, jnp.asarray(IDS, jnp.int32), jnp.int32(0),
        jfwd.init_cache(model.spec, jnp.float32))
    return np.asarray(out)


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_upcast_forward_matches_quant(files, arch):
    tm = _load(files[arch], arch, "torch")
    dense = tparams.upcast_model_weights(tm.params, torch.float32)
    for f in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        w = getattr(dense.layers, f)
        if w is not None:
            assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
    assert dense.layers.w_qkv is None and dense.layers.w_gate_up is None
    assert isinstance(dense.wte, torch.Tensor)
    got = _t_logits(tm, dense)
    np.testing.assert_allclose(got, _t_logits(tm, tm.params), **TOL)

    jm = _load(files[arch], arch, "jax")
    want = _j_logits(jm, jparams.upcast_model_weights(jm.params, jnp.float32))
    np.testing.assert_allclose(got, want, **TOL)


def test_upcast_matches_dequant_oracle(files, monkeypatch):
    monkeypatch.setenv("LLM_TPU_FUSE", "0")  # the reference's split planes
    jm = _load(files["llama"], "llama", "jax")
    tm = _load(files["llama"], "llama", "torch")
    dense = tparams.upcast_model_weights(tm.params, torch.float32)
    for f in ("wq", "wk", "wv", "w_gate", "w_up", "wo", "w_down"):
        qt = getattr(jm.params.layers, f)
        assert isinstance(qt, JQuantTensor) and qt.scale.ndim == 3
        for i in range(qt.scale.shape[0]):
            sl = JQuantTensor(
                qt.fmt_name, qt.k, qt.r, qt.lo[i],
                qt.hi[i] if qt.hi is not None else None,
                qt.scale[i], qt.bias[i] if qt.bias is not None else None,
            )
            np.testing.assert_array_equal(
                getattr(dense.layers, f)[i].numpy(),
                np.asarray(dequant_jnp(sl)))


def test_upcast_handles_fused_weights(files, monkeypatch):
    """The port fuses q|k|v and gate|up at load; the upcast of the fused
    model equals the reference's split quantized model."""
    tm = _load(files["llama"], "llama", "torch")
    assert tm.params.layers.w_qkv is not None
    assert tm.params.layers.w_gate_up is not None
    monkeypatch.setenv("LLM_TPU_FUSE", "0")
    split = _load(files["llama"], "llama", "jax")
    assert split.params.layers.w_qkv is None
    dense = tparams.upcast_model_weights(tm.params, torch.float32)
    np.testing.assert_allclose(_t_logits(tm, dense),
                               _j_logits(split, split.params), **TOL)


def test_gate_default_off_and_auto(files, monkeypatch):
    monkeypatch.delenv("LLM_TPU_DENSE_UPCAST", raising=False)
    monkeypatch.delenv("LLM_TPU_DENSE_UPCAST_MAX_MB", raising=False)
    tm = _load(files["llama"], "llama", "torch")
    assert isinstance(tm.params.layers.w_qkv, QuantTensor)  # default: off
    same = tparams.maybe_upcast_dense(tm.params)
    assert same.layers.w_qkv is tm.params.layers.w_qkv

    for value in ("auto", "yes"):  # an unknown value means auto
        monkeypatch.setenv("LLM_TPU_DENSE_UPCAST", value)
        assert tparams._dense_upcast_max_bytes() == \
            jparams._dense_upcast_max_bytes() == 256 << 20
        up = tparams.maybe_upcast_dense(tm.params)
        assert isinstance(up.layers.wq, torch.Tensor)
        assert up.layers.wq.dtype == torch.bfloat16  # bf16 on the CPU too
        assert up.layers.w_qkv is None

    monkeypatch.setenv("LLM_TPU_DENSE_UPCAST_MAX_MB", "0")
    kept = tparams.maybe_upcast_dense(tm.params)
    assert isinstance(kept.layers.w_qkv, QuantTensor)
    monkeypatch.setenv("LLM_TPU_DENSE_UPCAST", "1")
    assert tparams._dense_upcast_max_bytes() == \
        jparams._dense_upcast_max_bytes()
    assert isinstance(tparams.maybe_upcast_dense(tm.params).layers.wq,
                      torch.Tensor)


def test_size_gate_leaves_out_wpe(files, monkeypatch):
    """GPT-2: the gate sums the layer weights, wte and lm_head, not wpe.
    At a gate of exactly that sum both packages upcast; one byte less and
    neither does."""
    monkeypatch.setenv("LLM_TPU_FUSE", "0")
    tm = _load(files["gpt2"], "gpt2", "torch")
    jm = _load(files["gpt2"], "gpt2", "jax")
    assert tm.params.wpe is not None
    total = sum(tparams._packed_bytes(w) for w in
                [getattr(tm.params.layers, f) for f in tparams._W_FIELDS]
                + [tm.params.wte, tm.params.lm_head] if w is not None)
    assert total == sum(
        jparams._packed_bytes(w) for w in
        [getattr(jm.params.layers, f) for f in jparams._W_FIELDS]
        + [jm.params.wte, jm.params.lm_head] if w is not None)
    for gate, upcast in ((total, True), (total - 1, False)):
        monkeypatch.setattr(tparams, "_dense_upcast_max_bytes",
                            lambda g=gate: g)
        monkeypatch.setattr(jparams, "_dense_upcast_max_bytes",
                            lambda g=gate: g)
        got = tparams.maybe_upcast_dense(tm.params)
        want = jparams.maybe_upcast_dense(jm.params)
        assert isinstance(got.wte, torch.Tensor) == upcast
        assert isinstance(want.wte, jnp.ndarray) == upcast


def test_loader_gate_logits_match_reference(files, monkeypatch):
    """LLM_TPU_DENSE_UPCAST=1 at load: both packages hold bf16 dense
    weights and give the same logits (f32 products on the CPU)."""
    monkeypatch.setenv("LLM_TPU_DENSE_UPCAST", "1")
    for arch in ("llama", "gpt2"):
        tm = _load(files[arch], arch, "torch")
        jm = _load(files[arch], arch, "jax")
        assert tm.params.layers.wq.dtype == torch.bfloat16
        assert isinstance(tm.params.wte, torch.Tensor)
        np.testing.assert_allclose(_t_logits(tm, tm.params),
                                   _j_logits(jm, jm.params), **TOL)


def test_dense_product_f32_out():
    """The card's dense product: bf16 operands and an f32 result, by
    torch.mm's out_dtype where this torch has it for the operands, else by
    casting the bf16 product up (the CPU takes the second way)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, 8, generator=g).to(torch.bfloat16)
    y = tqm._mm_f32_out(a, b)
    assert y.dtype == torch.float32 and tqm.MM_OUT_DTYPE is not None
    want = a.float() @ b.float()
    assert torch.allclose(y, want, rtol=2 ** -7, atol=2 ** -7)
