"""The port's session snapshots (`InferenceSession.get_snapshot` /
`from_snapshot`, `snapshot.write_session` / `read_session` /
`read_or_create_session`) against the JAX package's, on a tiny LLaMA Q4_0
written by the JAX package's `make_tiny_file` and loaded by both
packages, for f32, bf16 and int8 caches (the int8 scales too):

- a round trip through `get_snapshot` / `from_snapshot` gives the cache,
  tokens, logits and n_past back exactly, and the same greedy tokens as
  an uninterrupted run;
- a session written by the port and read by the reference, and one
  written by the reference and read by the port, continue with greedy
  tokens equal to an uninterrupted run; the snapshot's header and KV
  bytes are the reference's format (a bf16 cache as its 2-byte words
  under "bfloat16");
- another context size, another cache layout of the same bytes, or a
  file that is no snapshot raises `SnapshotError`.

Greedy: the host chain `topk:k=1` (its default repetition penalty) with
EoT banned. Tokens are compared exactly; the restored cache bit-equal."""

import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_archs import load_both, one_torch_thread  # noqa: F401

from llm_tpu import session as jsession
from llm_tpu import snapshot as jsnap
from llm_tpu.ggml.types import GgmlType
from llm_tpu.samplers import build_sampler_chain as j_chain
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch import session as tsession
from llm_tpu_torch import snapshot as tsnap
from llm_tpu_torch.samplers import build_sampler_chain as t_chain

KVS = ["f32", "bf16", "int8"]
PROMPT = [2, 9, 4, 5, 17, 30, 8, 11, 3]
N_FIRST, N_MORE = 5, 6
SIDES = {"jax": (jsession, j_chain, jsnap),
         "torch": (tsession, t_chain, tsnap)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_snapshot") / "llama.bin"
    make_tiny_file("llama", path, GgmlType.Q4_0)
    jm, tm = load_both(path, "llama")
    return {"jax": jm, "torch": tm, "path": path}


def _config(S, kv):
    t = {"f32": S.ModelKVMemoryType.Float32,
         "bf16": S.ModelKVMemoryType.Float16,
         "int8": S.ModelKVMemoryType.Int8}[kv]
    return S.InferenceSessionConfig(memory_k_type=t, memory_v_type=t)


def _generate(side, sess, n):
    S, chain, _ = SIDES[side]
    params = S.InferenceParameters(
        sampler=chain(["topk:k=1"], bias=[(0, float("-inf"))]))
    rng = np.random.default_rng(0)
    for _ in range(n):
        sess.infer_next_token(rng, params)
    return list(sess.tokens)


def _uninterrupted(models, side, kv):
    S = SIDES[side][0]
    sess = S.InferenceSession(models[side], _config(S, kv))
    sess.feed_prompt(PROMPT)
    return _generate(side, sess, N_FIRST + N_MORE)


def _cache_numpy(cache):
    out = []
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if t is None:
            out.append(None)
        elif isinstance(t, torch.Tensor):
            out.append(t.view(torch.int16).numpy() if t.dtype ==
                       torch.bfloat16 else t.numpy())
        else:
            a = np.asarray(t)
            out.append(a.view(np.int16) if a.dtype == jnp.bfloat16 else a)
    return out


@pytest.mark.parametrize("kv", KVS)
def test_round_trip(models, kv):
    tm = models["torch"]
    sess = tsession.InferenceSession(tm, _config(tsession, kv))
    sess.feed_prompt(PROMPT)
    _generate("torch", sess, N_FIRST)
    snap = sess.get_snapshot()
    assert snap.k_dtype == {"f32": "float32", "bf16": "bfloat16",
                            "int8": "int8"}[kv]
    assert (snap.memory_k_scale is not None) == (kv == "int8")
    back = tsession.InferenceSession.from_snapshot(snap, tm)
    assert back.cache.k.device == tm.device
    assert back.n_past == sess.n_past and back.tokens == sess.tokens
    assert bytes(back.decoded_tokens) == bytes(sess.decoded_tokens)
    np.testing.assert_array_equal(back.last_logits, sess.last_logits)
    for a, b in zip(_cache_numpy(back.cache), _cache_numpy(sess.cache)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert _generate("torch", back, N_MORE) == \
        _uninterrupted(models, "torch", kv)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_cross_package_session(models, tmp_path, kv, writer, reader):
    WS = SIDES[writer][0]
    sess = WS.InferenceSession(models[writer], _config(WS, kv))
    sess.feed_prompt(PROMPT)
    _generate(writer, sess, N_FIRST)
    path = tmp_path / "s.session"
    SIDES[writer][2].write_session(sess, path)
    back = SIDES[reader][2].read_session(models[reader], path)
    assert back.n_past == len(PROMPT) + N_FIRST
    np.testing.assert_array_equal(back.last_logits, sess.last_logits)
    for a, b in zip(_cache_numpy(back.cache), _cache_numpy(sess.cache)):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    want = _uninterrupted(models, reader, kv)
    assert _generate(reader, back, N_MORE) == want
    assert want == _uninterrupted(models, writer, kv)


@pytest.mark.parametrize("kv", KVS)
def test_same_bytes_as_the_reference(models, tmp_path, kv):
    """The port's file holds the reference's header, word for word, and a
    payload of the same layout: the logits, then K and V (then the int8
    scales); the logits and an f32 cache agree within 1e-5."""
    blobs = {}
    for side in ("jax", "torch"):
        S, _, snap = SIDES[side]
        sess = S.InferenceSession(models[side], _config(S, kv))
        sess.feed_prompt(PROMPT)
        snap.write_session(sess, tmp_path / side)
        raw = (tmp_path / side).read_bytes()
        assert raw[:4] == b"LTSN" and struct.unpack("<I", raw[4:8]) == (2,)
        (hlen,) = struct.unpack("<I", raw[9:13])
        header = json.loads(raw[13:13 + hlen])
        blobs[side] = header, zlib.decompress(raw[13 + hlen:]) \
            if raw[8] == 0 else None
    (jh, jb), (th, tb) = blobs["jax"], blobs["torch"]
    assert th == jh
    if jb is not None and tb is not None:
        ll = jh["ll_len"]
        np.testing.assert_allclose(np.frombuffer(tb[:ll], np.float32),
                                   np.frombuffer(jb[:ll], np.float32),
                                   rtol=1e-5, atol=1e-5)
        assert len(tb) == len(jb)
        if kv == "f32":
            np.testing.assert_allclose(np.frombuffer(tb[ll:], np.float32),
                                       np.frombuffer(jb[ll:], np.float32),
                                       rtol=1e-5, atol=1e-5)


def test_mismatch_raises(models, tmp_path):
    tm = models["torch"]
    sess = tsession.InferenceSession(tm, _config(tsession, "f32"))
    sess.feed_prompt(PROMPT)
    snap = sess.get_snapshot()
    # another context size: another byte count
    other = tloader.load(models["path"], "llama", device="cpu",
                         params=tloader.ModelParameters(context_size=32))
    with pytest.raises(tsession.SnapshotError, match="size"):
        tsession.InferenceSession.from_snapshot(snap, other)
    # the same bytes in a position-major layout
    L, B, H, S, D = snap.k_shape
    snap.k_shape = snap.v_shape = (L, B, S, H, D)
    with pytest.raises(tsession.SnapshotError, match="layout"):
        tsession.InferenceSession.from_snapshot(snap, tm)
    bad = tmp_path / "bad.session"
    bad.write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(tsession.SnapshotError, match="not a session"):
        tsnap.read_session(tm, bad)


def test_read_or_create_precedence(models, tmp_path):
    """persist (when it exists) > load > a new session."""
    tm = models["torch"]
    config = _config(tsession, "f32")
    sess, loaded = tsnap.read_or_create_session(tm, tmp_path / "p", None,
                                                config)
    assert not loaded and sess.n_past == 0
    sess.feed_prompt(PROMPT)
    tsnap.write_session(sess, tmp_path / "p")
    short = tsession.InferenceSession(tm, config)
    short.feed_prompt(PROMPT[:3])
    tsnap.write_session(short, tmp_path / "l")
    s1, l1 = tsnap.read_or_create_session(tm, tmp_path / "p", tmp_path / "l",
                                          config)
    s2, l2 = tsnap.read_or_create_session(tm, None, tmp_path / "l", config)
    assert l1 and l2 and s1.n_past == len(PROMPT) and s2.n_past == 3
