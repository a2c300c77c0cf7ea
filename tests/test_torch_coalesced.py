"""The port's coalesced weight layout (llm_tpu_torch.ops.packing.QuantTensorC
and its functions, ops.qmatmul's tiling rules and the K3 path) against the
JAX package's, on the same raw GGML bytes.

Tolerances:
- layout, tiling and dequantization: none. Re-tiling, byte packing and
  f16 -> f32 expansion are exact in both packages: array equality of the
  bits.
- qmatmul over a coalesced weight (plain on the CPU) against the TPU kernel
  K3 in Pallas interpret mode: `test_torch_qmatmul.assert_kernel_close`,
  2^-7 (|x| @ |W|) against the kernel's bf16 rounding and 1e-5 of max|y|
  against the same bf16 math; and bit-equal to the port's plain path over
  the planes the buffer was made from.
- a tiny coalesced LLaMA carried from the JAX package: logits within atol =
  rtol = 1e-5 of the JAX forward (`test_torch_model.py`'s tolerance), greedy
  tokens equal."""

import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu import session as jsession
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.ops import packing as jpk
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import session as tsession
from llm_tpu_torch.models.params import coalesce_layer_weights, \
    params_from_numpy
from llm_tpu_torch.ops import packing as tpk
from llm_tpu_torch.ops import qmatmul as tqm
from llm_tpu_torch.samplers import build_sampler_chain as t_chain
from test_torch_model import _greedy_infer, _steps, jax_params_tree
from test_torch_packing import ALL_TYPES, assert_planes_equal, plane_bits, \
    random_raw
from test_torch_qmatmul import assert_kernel_close, bf16_math

jqm = importlib.import_module("llm_tpu.ops.qmatmul")  # the package
# re-exports the function under the module's name
K, R = 512, 256


def _pair(t, K=K, R=R, seed=0, L=None):
    """The same weight packed by both packages (stacked over L layers of
    distinct raw bytes when L is given)."""
    if L is None:
        raw = random_raw(t, K, R, seed)
        return jpk.pack_ggml(t, raw, (K, R)), tpk.pack_ggml(t, raw, (K, R))
    pairs = [_pair(t, K, R, seed + l) for l in range(L)]

    def stack(qs, st):
        return type(qs[0])(qs[0].fmt_name, K, R, *(
            None if getattr(qs[0], n) is None
            else st([getattr(q, n) for q in qs])
            for n in ("lo", "hi", "scale", "bias")))

    return (stack([p[0] for p in pairs], jnp.stack),
            stack([p[1] for p in pairs], torch.stack))


def _tilings(q):
    """The default tiling, and a multi-tile one (several k- and r-tiles)
    where the format allows one (the reference's rules; their equality is
    tested below)."""
    tk, tr, _ = jqm.coalesce_tiles(q.fmt, q.k_padded, q.r_padded,
                                   q.scale_packed)
    out = [(tk, tr)]
    for tk2 in (256, 128):
        segs = jpk.coalesced_seg_rows(q.fmt, tk2, q.scale_packed)
        if q.k_padded % tk2 == 0 and all(s % 8 == 0 for s in segs if s):
            out.append((tk2, 128))
            break
    return out


def assert_buf_equal(tc, jc):
    assert (tc.fmt_name, tc.k, tc.r, tc.kp, tc.rp, tc.tile_k, tc.tile_r,
            tc.scale_packed, tc.splits) == \
        (jc.fmt_name, jc.k, jc.r, jc.kp, jc.rp, jc.tile_k, jc.tile_r,
         jc.scale_packed, jc.splits)
    assert tc.buf.dtype == torch.int32
    np.testing.assert_array_equal(plane_bits(tc.buf), np.asarray(jc.buf))


def _variants(jq, tq):
    """(reference planes, port planes): as packed, with f32 scales, and R
    padded to 512."""
    yield jq, tq
    if jq.scale_packed:
        yield jpk.unpack_scales_qt(jq), tpk.unpack_scales_qt(tq)
    yield jpk.pad_r_qt(jq, 512), tpk.pad_r_qt(tq, 512)


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_coalesce_qt_bit_equal(t):
    for L in (None, 2):
        jq, tq = _pair(t, seed=3, L=L)
        for jv, tv in _variants(jq, tq):
            assert_planes_equal(tv, jv)
            for tk, tr in _tilings(jv):
                assert_buf_equal(tpk.coalesce_qt(tv, tk, tr),
                                 jpk.coalesce_qt(jv, tk, tr, to_device=False))


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_uncoalesce_roundtrip(t):
    for L in (None, 2):
        jq, tq = _pair(t, seed=5, L=L)
        for jv, tv in _variants(jq, tq):
            for tk, tr in _tilings(jv):
                tc = tpk.coalesce_qt(tv, tk, tr)
                back = tpk.uncoalesce_qt(tc)
                for p in ("lo", "hi", "scale", "bias"):
                    a, b = getattr(tv, p), getattr(back, p)
                    assert (a is None) == (b is None), p
                    if a is not None:
                        assert a.dtype == b.dtype and torch.equal(a, b), p
                if L:  # a layer's view is the layer's own buffer
                    one = tpk.coalesce_qt(tv.layer(1), tk, tr)
                    assert torch.equal(tc.layer(1).buf, one.buf)


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_dequant_c_equals_reference(t):
    jq, tq = _pair(t, seed=7)
    tk, tr = _tilings(jq)[-1]
    jc = jpk.coalesce_qt(jq, tk, tr)
    tc = tpk.coalesce_qt(tq, tk, tr)
    for trim in (True, False):
        np.testing.assert_array_equal(
            tpk.dequant_c(tc, trim).numpy(),
            np.asarray(jpk.dequant_c_jnp(jc, trim=trim)))


# (K, R) of the 7B weights (fused as the port fuses them) and gpt2's K=768
TILE_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 12288),
               (4096, 22016), (4096, 32000), (768, 768)]


@pytest.mark.parametrize("K,R", TILE_SHAPES,
                         ids=[f"{k}x{r}" for k, r in TILE_SHAPES])
def test_coalesce_tiles_and_auto_match(K, R, monkeypatch):
    fmt = tpk.FORMATS[GgmlType.Q4_0]
    Kp = tpk._round_up(K, tpk.k_granule(fmt, K))  # as pack_ggml pads K
    for packed in (True, False):
        try:
            ref = jqm.coalesce_tiles(jpk.FORMATS[GgmlType.Q4_0], Kp, R,
                                     packed)
        except ValueError:
            ref = None
        try:
            got = tqm.coalesce_tiles(fmt, Kp, R, packed)
        except ValueError:
            got = None
        assert got == ref
    # coalesce_auto on zero planes of the full shape (packed scales, as
    # pack_ggml lays them out), its buffer not built: the plan depends on
    # the shapes alone
    planes = dict(lo=(Kp // 8, R), scale=(Kp // 64, R))
    jz = jpk.QuantTensor("q4_0", K, R, *(
        None if n not in planes else np.zeros(planes[n], np.uint32)
        for n in ("lo", "hi", "scale", "bias")))
    tz = tpk.QuantTensor("q4_0", K, R, *(
        None if n not in planes else torch.zeros(planes[n], dtype=torch.int32)
        for n in ("lo", "hi", "scale", "bias")))

    def plan(q, tile_k, tile_r, to_device=True):
        return (q.k_padded, q.r_padded, q.scale_packed, tile_k, tile_r)

    monkeypatch.setattr(jpk, "coalesce_qt", plan)
    monkeypatch.setattr(tqm, "coalesce_qt", plan)
    for min_k in (2048, 0):
        assert tqm.coalesce_auto(tz, min_k=min_k) == \
            jqm.coalesce_auto(jz, min_k=min_k)


def test_unfuse_coalesced_equals_reference():
    t = GgmlType.Q4_0
    pairs = [_pair(t, seed=40 + i) for i in range(3)]
    jf = jpk.fuse_quant([p[0] for p in pairs])
    tf = tpk.fuse_quant([p[1] for p in pairs])
    tk, tr, _ = jqm.coalesce_tiles(jf.fmt, jf.k_padded, jf.r_padded,
                                   jf.scale_packed)
    jm = jpk.unfuse_quant(jpk.coalesce_qt(jf, tk, tr))
    tm = tpk.unfuse_quant(tpk.coalesce_qt(tf, tk, tr))
    assert len(tm) == len(jm) == 3
    for a, b, (_, member) in zip(tm, jm, pairs):
        assert_planes_equal(a, b)
        assert_planes_equal(a, member)
    assert tpk.unfuse_quant(pairs[0][1]) is None  # not fused


# -- K3 on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_qmatmul_coalesced_matches_k3_interpret(t):
    jq, tq = _pair(t, seed=11)
    tk, tr = _tilings(jq)[-1]
    jc = jpk.coalesce_qt(jq, tk, tr)
    tc = tpk.coalesce_qt(tq, tk, tr)
    x = np.random.default_rng(12).standard_normal((3, K)).astype(np.float32)
    launches = tqm.LAUNCHES, tqm.LAUNCHES_COALESCED
    y = tqm.qmatmul(torch.from_numpy(x), tc)
    assert (tqm.LAUNCHES, tqm.LAUNCHES_COALESCED) == launches  # CPU: plain
    np.testing.assert_array_equal(
        y.numpy(), tqm.qmatmul(torch.from_numpy(x), tq).numpy())
    y_k3 = np.asarray(jqm._qmatmul_pallas_c(jnp.asarray(x), jc,
                                            interpret=True))
    assert_kernel_close(y.numpy(), y_k3, bf16_math(x, tq), x, tq)


@pytest.mark.parametrize("t", [GgmlType.Q4_0, GgmlType.Q8_0, GgmlType.Q4_K],
                         ids=lambda t: t.name)
def test_qmatmul_coalesced_stacked_matches_k3_interpret(t):
    L = 2
    jq, tq = _pair(t, seed=20, L=L)
    tk, tr, _ = jqm.coalesce_tiles(jq.fmt, jq.k_padded, jq.r_padded,
                                   jq.scale_packed)
    jc = jpk.coalesce_qt(jq, tk, tr)
    tc = tpk.coalesce_qt(tq, tk, tr)
    x = np.random.default_rng(21).standard_normal((2, K)).astype(np.float32)
    for layer in range(L):
        y = tqm.qmatmul(torch.from_numpy(x), tc, layer=layer).numpy()
        np.testing.assert_array_equal(
            y, tqm.qmatmul(torch.from_numpy(x), tq.layer(layer)).numpy())
        y_k3 = np.asarray(jqm._qmatmul_pallas_c_stacked(
            jnp.asarray(x), jc, jnp.int32(layer), interpret=True))
        assert_kernel_close(y, y_k3, bf16_math(x, tq.layer(layer)), x,
                            tq.layer(layer))


# -- a coalesced model ----------------------------------------------------------


@pytest.fixture(scope="module")
def coalesced_models(tmp_path_factory):
    """A tiny LLaMA Q4_0 at n_embd 512 (every layer weight has a legal
    coalesced tiling), loaded by the JAX package with coalescing on and the
    size gate lowered, and by the port (planes)."""
    path = tmp_path_factory.mktemp("torch_coalesced") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0, n_embd=512, n_head=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLM_TPU_COALESCE", "1")
        mp.setenv("LLM_TPU_COALESCE_MIN_K", "0")
        jm = j_load(path, "llama", params=JModelParameters(context_size=64))
    tm = tloader.load(path, "llama",
                      params=tloader.ModelParameters(context_size=64),
                      device="cpu")
    return jm, tm


def test_carried_coalesced_params_match_jax_forward(coalesced_models):
    jm, tm = coalesced_models
    lw = jm.params.layers
    assert isinstance(lw.w_qkv, jpk.QuantTensorC)
    assert isinstance(lw.w_gate_up, jpk.QuantTensorC)
    assert isinstance(lw.w_down, jpk.QuantTensorC)
    carried = params_from_numpy(jax_params_tree(jm.params), "cpu")
    for f in ("w_qkv", "wo", "w_gate_up", "w_down"):
        tw, jw = getattr(carried.layers, f), getattr(lw, f)
        assert isinstance(tw, tpk.QuantTensorC), f
        assert_buf_equal(tw, jw)
    tc = copy.copy(tm)
    tc.params = carried
    rng = np.random.default_rng(9)
    chunks = [rng.integers(1, 96, n).tolist() for n in (13, 1, 1)]
    ref = _steps(jfwd, jm, jnp.float32, chunks,
                 lambda ids: jnp.asarray(ids, jnp.int32))
    got = _steps(tfwd, tc, torch.float32, chunks, torch.tensor)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    eot = [(0, float("-inf"))]
    prompt = list(rng.integers(1, 96, 11))
    jt, _ = _greedy_infer(jsession, jm, j_chain(["topk:k=1"], bias=eot),
                          prompt, 8)
    tt, _ = _greedy_infer(tsession, tc, t_chain(["topk:k=1"], bias=eot),
                          prompt, 8)
    assert tt == jt


def test_coalesce_layer_weights_matches_reference_layout(coalesced_models):
    """The port's own coalescing of its loaded planes gives the buffers the
    JAX package loaded, and the same logits as the planes, bit for bit."""
    jm, tm = coalesced_models
    cp = coalesce_layer_weights(tm.params, min_k=0)
    for f in ("w_qkv", "wo", "w_gate_up", "w_down"):
        assert_buf_equal(getattr(cp.layers, f), getattr(jm.params.layers, f))
    assert isinstance(cp.lm_head, tpk.QuantTensor)  # the head stays planes
    assert coalesce_layer_weights(tm.params).layers.wo is tm.params.layers.wo
    tc = copy.copy(tm)
    tc.params = cp
    chunks = [[5, 9, 2, 17], [3]]
    got = _steps(tfwd, tc, torch.float32, chunks, torch.tensor)
    ref = _steps(tfwd, tm, torch.float32, chunks, torch.tensor)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
