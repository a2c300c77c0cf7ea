"""The port's six other architectures (GPT-2, GPT-J, GPT-NeoX, BLOOM, MPT,
Falcon-7B's one shared LN and Falcon-40B's two LNs at n_head_kv = 2)
against the JAX package, each in Q4_0, Q5_1, Q8_0 and Q4_K, on tiny
checkpoints written by the JAX package's `make_tiny_file` and loaded by
both packages: the params the port loads equal the JAX package's carried
over (`params_from_numpy`), the fused q|k|v undone and redone exactly,
and `forward_step` logits (a prefill through the materialized and the
online attention branch, then decode steps). test_torch_archs_infer.py
holds greedy `infer`, the decode loop and the CLI on the same files.

The geometry is the reference's tiny one (n_embd 64, 4 heads, 2 layers,
vocab 96: the lm_head's R is not a multiple of 128), with n_embd 256 for
Q4_K (K-quant blocks span 256). GPT-J and GPT-NeoX rotate half of each
head (n_rot = head_dim / 2), as GPT-J-6B (64 of 256) and StableLM do.

Tolerance for logits, over an f32 cache (the cache's dtype is no part of
an architecture; test_torch_model.py holds the bf16 and int8 caches):
atol = rtol = 1e-5, as test_torch_model.py: f32 on both sides, sums in
another order (torch vs XLA). Q4_K's random tiny weights (6-bit scales
times d up to 0.05 a weight) give logits in the tens, and the f32 rounding
error of the sums grows with that magnitude, not with each element's:
held to 1e-4 of the chunk's largest logit, the tolerance of the
reference's own Q4_K model test (tests/test_models.py:127)."""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import _assert_weight_equal, jax_params_tree

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu.ggml.types import GgmlType
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.models.params import (
    LayerParams,
    fuse_layer_weights,
    params_from_numpy,
    unfuse_layer_weights,
)

CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
# (id, architecture, hparam overrides)
LAYOUTS = [
    ("gpt2", "gpt2", {}),
    ("gptj", "gptj", {"rot_half": True}),
    ("gptneox", "gptneox", {"rot_half": True}),
    ("bloom", "bloom", {}),
    ("mpt", "mpt", {}),
    ("falcon7b", "falcon", {}),
    ("falcon40b", "falcon", {"n_head_kv": 2}),
]
FORMATS = [GgmlType.Q4_0, GgmlType.Q5_1, GgmlType.Q8_0, GgmlType.Q4_K]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module of these tests runs: the tiny
    models' ops are too small to share out, and the suite's workers share
    the CPU, where idle OpenMP threads spinning against each other made
    these tests several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_tiny(arch, path, et, overrides, seed=0):
    """make_tiny_file with the layout's overrides (n_embd 256 for K-quants;
    `rot_half`: rope over half of each head)."""
    kw = dict(overrides)
    if et == GgmlType.Q4_K:
        kw["n_embd"] = 256
    if kw.pop("rot_half", False):
        kw["n_rot"] = kw.get("n_embd", 64) // 4 // 2
    return make_tiny_file(arch, path, et, seed=seed, **kw)


def load_both(path, arch, ctx=CTX):
    jm = j_load(path, arch, params=JModelParameters(context_size=ctx))
    tm = tloader.load(path, arch,
                      params=tloader.ModelParameters(context_size=ctx),
                      device="cpu")
    return jm, tm


@pytest.fixture(scope="module",
                params=[(lay, et) for lay in LAYOUTS for et in FORMATS],
                ids=[f"{lay[0]}-{et.name.lower()}" for lay in LAYOUTS
                     for et in FORMATS])
def models(request, tmp_path_factory):
    (name, arch, overrides), et = request.param
    path = tmp_path_factory.mktemp(f"torch_archs_{name}") / f"{name}.bin"
    write_tiny(arch, path, et, overrides)
    return (name, arch, *load_both(path, arch))


def test_carried_params_equal_loaded(models):
    name, arch, jm, tm = models
    assert asdict(tm.spec) == asdict(jm.spec)
    carried = params_from_numpy(jax_params_tree(jm.params), "cpu")
    assert tm.params.layers.w_qkv is not None  # fused as the reference is
    for f in LayerParams.__dataclass_fields__:
        _assert_weight_equal(getattr(carried.layers, f),
                             getattr(tm.params.layers, f), f)
    for f in tm.params.__dataclass_fields__:
        if f != "layers":
            _assert_weight_equal(getattr(carried, f), getattr(tm.params, f),
                                 f)
    # the tied heads of MPT (always) and GPT-2 (no model/lm_head)
    assert (tm.params.lm_head is None) == (arch in ("mpt", "gpt2"))
    # the fusion's inverse gives the split weights back, members exact
    split = unfuse_layer_weights(tm.params.layers)
    assert split.w_qkv is None and split.wq is not None
    again = fuse_layer_weights(split)
    _assert_weight_equal(again.w_qkv, tm.params.layers.w_qkv, "w_qkv")


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


@pytest.mark.parametrize("online", [False, True], ids=["materialized",
                                                       "online"])
def test_forward_step_logits_match(models, monkeypatch, online):
    _, _, jm, tm = models
    if online:  # force the block-wise online prefill branch in both
        for fwd in (jfwd, tfwd):
            monkeypatch.setattr(fwd, "_ONLINE_MIN_SCORE_BYTES", 0)
            monkeypatch.setattr(fwd, "_KV_BLOCK", 16)
    rng = np.random.default_rng(7)
    chunks = [rng.integers(1, 96, n).tolist() for n in (21, 11, 1, 1)]
    ref = _steps(jfwd, jm, jnp.float32, chunks,
                 lambda ids: jnp.asarray(ids, jnp.int32))
    got = _steps(tfwd, tm, torch.float32, chunks, torch.tensor)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if tm.params.layers.w_down.fmt_name == "q4_k":
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())
        else:
            np.testing.assert_allclose(g, r, **TOL)
