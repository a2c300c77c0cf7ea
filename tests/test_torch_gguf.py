"""The port's GGUF container (`llm_tpu_torch/ggml/gguf.py`) and its loader
branch against the JAX package's, on tiny checkpoints written by the JAX
package's `make_tiny_file`:

- the port's `GgufReader` against the reference's on files written by
  either package, and by the reference's `quantize`: metadata, tensor
  index, `fetch` bytes, vocabulary, hyperparameters;
- `convert_ggml_to_gguf` and the cli's `gguf-convert` byte-equal to the
  reference's, for every architecture, with merges and a chat template;
- a GGUF load of each architecture (LLaMA, MPT, Falcon and GPT-NeoX in
  Q4_0 and Q4_K, the other three in Q4_0): planes equal to the port's
  GGML load of the same weights, logits against the reference's GGUF
  load; the Falcon-40B two-norm layout;
- rope settings in the metadata (`rope.freq_base` 1e6, `scale_linear`,
  `rope.scaling.*`), overridden by `--rope-*`;
- SentencePiece surface forms: '▁', `<0xNN>` byte tokens and control
  tokens (type 3) kept verbatim;
- untrusted headers: version, alignment, counts, truncated data.

Tolerance for logits: atol = rtol = 1e-5 (f32 cache on both sides, sums
in another order; test_torch_model.py); Q4_K's logits in the tens: 1e-4
of the largest logit (test_torch_archs.py). Planes, bytes, metadata,
token ids and cli output are equal."""

import io
import json
import random
import struct
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_archs import (  # noqa: F401 (an autouse fixture)
    load_both,
    one_torch_thread,
    write_tiny,
)
from test_torch_model import _assert_weight_equal

import llm_tpu.models.forward as jfwd
import llm_tpu_torch.models.forward as tfwd
from llm_tpu.cli import main as j_main
from llm_tpu.ggml import gguf as jg
from llm_tpu.ggml.types import GgmlType
from llm_tpu.quantize import quantize as j_quantize
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.ggml import gguf as tg
from llm_tpu_torch.ggml.reader import FormatError
from llm_tpu_torch.ggml.writer import SaveError
from llm_tpu_torch.models.params import LayerParams

CTX = 64
TOL = dict(rtol=1e-5, atol=1e-5)
IDS = [3, 17, 5, 9, 40]


def _hp(h) -> dict:
    """Hyperparameters as plain values (each package has its own enum)."""
    ft = h.file_type
    return {**vars(h), "file_type": (int(ft.format),
                                     ft.quantization_version)}


def _assert_reader_equal(t, j):
    """Every field the loader reads, the port's reader against the
    reference's on one file."""
    assert (t.container.kind, t.container.version) == \
        (j.container.kind, j.container.version)
    assert t.metadata == j.metadata
    assert t.vocabulary.tokens == j.vocabulary.tokens
    assert t.vocabulary.scores == j.vocabulary.scores
    assert _hp(t.hyperparameters) == _hp(j.hyperparameters)
    assert t.source_names == j.source_names
    assert list(t.tensors) == list(j.tensors)
    for name, ti in t.tensors.items():
        ji = j.tensors[name]
        assert (ti.n_dims, ti.dims, int(ti.element_type), ti.start_offset) \
            == (ji.n_dims, ji.dims, int(ji.element_type), ji.start_offset)
        np.testing.assert_array_equal(t.fetch(name), j.fetch(name))
        np.testing.assert_array_equal(t.fetch_f32(name), j.fetch_f32(name))


def _logits(side_fwd, model, ids=IDS):
    """Prefill logits then one decode step's, over an f32 cache."""
    if side_fwd is jfwd:
        cache = jfwd.init_cache(model.spec, jnp.float32)
        a, _, cache = jfwd.forward_step(model.spec, model.params,
                                        jnp.asarray(ids, jnp.int32),
                                        jnp.int32(0), cache)
        b, _, _ = jfwd.forward_step(model.spec, model.params,
                                    jnp.asarray([7], jnp.int32),
                                    jnp.int32(len(ids)), cache)
        return np.concatenate([np.asarray(a), np.asarray(b)])
    cache = tfwd.init_cache(model.spec, torch.float32, "cpu")
    a, _, cache = tfwd.forward_step(model.spec, model.params,
                                    torch.tensor(ids), 0, cache)
    b, _, _ = tfwd.forward_step(model.spec, model.params, torch.tensor([7]),
                                len(ids), cache)
    return torch.cat([a, b]).numpy()


def _assert_logits(got, ref, et):
    if et == GgmlType.Q4_K:
        atol = 1e-4 * float(np.max(np.abs(ref)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    else:
        np.testing.assert_allclose(got, ref, **TOL)


def _assert_params_equal(a, b):
    for f in LayerParams.__dataclass_fields__:
        _assert_weight_equal(getattr(a.layers, f), getattr(b.layers, f), f)
    for f in a.__dataclass_fields__:
        if f != "layers":
            _assert_weight_equal(getattr(a, f), getattr(b, f), f)


def _tokenizer_view(tok, n):
    return [tok.token(i) for i in range(n)]


def _rewrite(src, out, extra_md=(), drop_tail_bytes=0, arch="llama"):
    """Re-emit a GGUF with the port's writer, extra metadata appended (and
    the tail cut)."""
    r = tg.GgufReader(src).load(arch)
    to_gguf = tg.gguf_name_fn(arch, r.metadata)
    with open(out, "wb") as f:
        w = tg.GgufWriter(f)
        for k, v in r.metadata.items():
            if k != "general.alignment":
                w.add_metadata(k, v)
        for k, v in extra_md:
            w.add_metadata(k, v)
        for name, info in r.tensors.items():
            w.add_tensor(to_gguf(name), info.element_type, info.dims,
                         bytes(r.fetch(name)))
        w.finish()
    if drop_tail_bytes:
        out.write_bytes(out.read_bytes()[:-drop_tail_bytes])
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_gguf")
    ggjt = d / "llama.bin"
    make_tiny_file("llama", ggjt)  # f32 weights: `quantize` takes them
    jgguf, tgguf = d / "j.gguf", d / "t.gguf"
    jg.convert_ggml_to_gguf(ggjt, jgguf, "llama")
    tg.convert_ggml_to_gguf(ggjt, tgguf, "llama")
    return ggjt, jgguf, tgguf


# -- the container ---------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_reader_matches_reference(files, writer):
    ggjt, jgguf, tgguf = files
    path = jgguf if writer == "reference" else tgguf
    assert tg.is_gguf(path) and not tg.is_gguf(ggjt)
    t = tg.GgufReader(path).load("llama")
    _assert_reader_equal(t, jg.GgufReader(path).load("llama"))
    assert t.container.kind == "gguf" and t.container.version == 3
    assert "layers.1.feed_forward.w2.weight" in t.tensors
    assert t.metadata["tokenizer.ggml.eos_token_id"] == 0
    assert t.metadata["llama.feed_forward_length"] > 0


ALL_ARCHS = ["llama", "gpt2", "gptj", "gptneox", "bloom", "mpt", "falcon"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_convert_byte_equal(arch, tmp_path):
    src = tmp_path / f"{arch}.bin"
    make_tiny_file(arch, src)
    jg.convert_ggml_to_gguf(src, tmp_path / "j.gguf", arch)
    tg.convert_ggml_to_gguf(src, tmp_path / "t.gguf", arch)
    data = (tmp_path / "t.gguf").read_bytes()
    assert data == (tmp_path / "j.gguf").read_bytes()
    # the stored names follow the GGUF convention (blk.N.*)
    names = set(tg.GgufReader(tmp_path / "t.gguf").load(arch)
                .source_names.values())
    assert "token_embd.weight" in names
    assert any(n.startswith("blk.1.") for n in names)


def test_convert_merges_and_chat_template(tmp_path):
    src = tmp_path / "gpt2.bin"
    make_tiny_file("gpt2", src)
    tj = tmp_path / "tokenizer.json"
    tj.write_text(json.dumps(
        {"model": {"type": "BPE", "merges": ["a b", ["ab", "c"]]}}))
    tmpl = "{% for m in messages %}<t2>{{ m.content }}{% endfor %}<t3>"
    kw = dict(tokenizer_json=tj, chat_template=tmpl,
              extra_metadata={"gpt2.attention.head_count_kv": 4})
    jg.convert_ggml_to_gguf(src, tmp_path / "j.gguf", "gpt2", **kw)
    tg.convert_ggml_to_gguf(src, tmp_path / "t.gguf", "gpt2", **kw)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    md = tg.GgufReader(tmp_path / "t.gguf").load("gpt2").metadata
    assert md["tokenizer.ggml.model"] == b"gpt2"
    assert md["tokenizer.ggml.merges"] == [b"a b", b"ab c"]
    assert tg._merges_from_tokenizer_json(tj) == \
        jg._merges_from_tokenizer_json(tj)


def test_cli_gguf_convert_then_info(files, tmp_path, capsys):
    ggjt = files[0]
    tmpl = "{% for m in messages %}{{ m.content }}{% endfor %}"
    outs = []
    for main, name, extra in ((j_main, "j.gguf", []),
                              (t_main, "t.gguf", [])):
        dst = tmp_path / name
        main(["gguf-convert", str(ggjt), str(dst), "-a", "llama",
              "--chat-template", tmpl])
        main(["info", "-m", str(dst), "-a", "llama", "-t", "-k"] + extra)
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert "Container type" in outs[1] and "gguf" in outs[1]
    assert "blk" not in outs[1] and "tok_embeddings.weight" in outs[1]
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    # the template reaches the model on both sides
    tm = tloader.load(tmp_path / "t.gguf", "llama",
                      params=tloader.ModelParameters(context_size=CTX),
                      device="cpu")
    jm = load_both(tmp_path / "j.gguf", "llama")[0]
    assert tm.chat_template == jm.chat_template == tmpl


QUANTIZED = [("ggjt->gguf", GgmlType.Q4_0), ("ggjt->gguf", GgmlType.Q5_1),
             ("gguf->gguf", GgmlType.Q8_0), ("gguf->ggjt", GgmlType.Q8_0)]


@pytest.mark.parametrize("route,et", QUANTIZED,
                         ids=[f"{r}-{e.name.lower()}" for r, e in QUANTIZED])
def test_reference_quantized_files(files, tmp_path, route, et):
    """Files the reference's `quantize` writes (GGUF from a classic file,
    GGUF to GGUF with the metadata passed through, GGUF to a classic
    file) read and load in the port as in the reference."""
    ggjt, jgguf, _ = files
    src = ggjt if route.startswith("ggjt") else jgguf
    dst = tmp_path / ("q.bin" if route.endswith("ggjt") else "q.gguf")
    j_quantize(src, dst, "llama", et)
    if dst.suffix == ".gguf":
        t = tg.GgufReader(dst).load("llama")
        _assert_reader_equal(t, jg.GgufReader(dst).load("llama"))
        info = t.tensors["layers.0.attention.wq.weight"]
        assert int(info.element_type) == int(et)
    jm, tm = load_both(dst, "llama")
    assert tm.container_type.kind == ("gguf" if dst.suffix == ".gguf"
                                      else "ggjt")
    _assert_logits(_logits(tfwd, tm), _logits(jfwd, jm), et)


# -- the loader ------------------------------------------------------------

LOADS = ([(a, GgmlType.Q4_0) for a in ALL_ARCHS]
         + [(a, GgmlType.Q4_K) for a in ("llama", "mpt", "falcon",
                                         "gptneox")])


@pytest.mark.parametrize("arch,et", LOADS,
                         ids=[f"{a}-{e.name.lower()}" for a, e in LOADS])
def test_gguf_load_matches_ggml_and_reference(arch, et, tmp_path):
    src = tmp_path / f"{arch}.bin"
    write_tiny(arch, src, et, {})
    dst = tmp_path / f"{arch}.gguf"
    tg.convert_ggml_to_gguf(src, dst, arch)
    jm, tm = load_both(dst, arch)
    tm_ggml = tloader.load(src, arch,
                           params=tloader.ModelParameters(context_size=CTX),
                           device="cpu")
    assert tm.container_type.kind == "gguf"
    assert tm.spec == tm_ggml.spec
    _assert_params_equal(tm.params, tm_ggml.params)
    n = len(tm.tokenizer)
    assert n == len(tm_ggml.tokenizer) == len(jm.tokenizer)
    assert _tokenizer_view(tm.tokenizer, n) == \
        _tokenizer_view(jm.tokenizer, n)
    got = _logits(tfwd, tm)
    np.testing.assert_array_equal(got, _logits(tfwd, tm_ggml))
    _assert_logits(got, _logits(jfwd, jm), et)


def test_falcon_40b_dual_norm_layout(tmp_path):
    src = tmp_path / "falcon40.bin"
    make_tiny_file("falcon", src, n_head_kv=2)
    dst = tmp_path / "falcon40.gguf"
    tg.convert_ggml_to_gguf(src, dst, "falcon")
    r = tg.GgufReader(dst).load("falcon")
    assert r.hyperparameters.n_head_kv == 2
    assert "transformer.h.0.ln_attn.weight" in r.tensors
    assert "transformer.h.0.ln_mlp.weight" in r.tensors
    jm, tm = load_both(dst, "falcon")
    got = _logits(tfwd, tm)
    np.testing.assert_allclose(got, _logits(jfwd, jm), **TOL)
    tm_ggml = tloader.load(src, "falcon",
                           params=tloader.ModelParameters(context_size=CTX),
                           device="cpu")
    np.testing.assert_array_equal(got, _logits(tfwd, tm_ggml))


def test_rope_metadata_reaches_the_spec(files, tmp_path):
    """`llama.rope.freq_base` 1e6 and `scale_linear` 4 in the file give the
    reference's spec and logits (the loader falls back to the file's rope
    settings); a `--rope-*` override wins."""
    out = _rewrite(files[2], tmp_path / "rope.gguf",
                   [("llama.rope.freq_base", 1e6),
                    ("llama.rope.scale_linear", 4.0)])
    jm, tm = load_both(out, "llama")
    assert tm.spec.rope_freq_base == 1e6 and tm.spec.rope_freq_scale == 0.25
    assert asdict(tm.spec) == asdict(jm.spec)
    got = _logits(tfwd, tm, list(range(2, 40)))
    np.testing.assert_allclose(got, _logits(jfwd, jm, list(range(2, 40))),
                               **TOL)
    plain = load_both(files[2], "llama")[1]
    assert not np.allclose(got, _logits(tfwd, plain, list(range(2, 40))),
                           **TOL)
    rope = tloader.RoPEOverrides(frequency_base=500000, frequency_scale=0.5)
    m2 = tloader.load(out, "llama", device="cpu",
                      params=tloader.ModelParameters(context_size=CTX,
                                                     rope_overrides=rope))
    assert m2.spec.rope_freq_base == 5e5 and m2.spec.rope_freq_scale == 0.5


def test_rope_scaling_type_bytes(files, tmp_path):
    out = _rewrite(files[2], tmp_path / "scaled.gguf",
                   [("llama.rope.scaling.type", "linear"),
                    ("llama.rope.scaling.factor", 4.0)])
    r = tg.GgufReader(out).load("llama")
    assert isinstance(r.metadata["llama.rope.scaling.type"], bytes)
    assert r.hyperparameters.rope_freq_scale == 0.25
    assert _hp(r.hyperparameters) == \
        _hp(jg.GgufReader(out).load("llama").hyperparameters)


def test_sentencepiece_surface_forms(files, tmp_path):
    """A GGUF vocabulary in SentencePiece surface forms: '▁' is a space,
    `<0xNN>` one byte, control tokens (type 3) keep their text; both
    loaders build the same tokenizer and give the same ids."""
    r = tg.GgufReader(files[2]).load("llama")
    toks = list(r.vocabulary.tokens)
    toks[10] = "▁hello".encode()
    toks[11] = b"<0x41>"
    toks[12] = b"<0x0A>"
    toks[13] = b"<ctl>"
    toks[14] = "▁▁".encode()
    types = [1] * len(toks)
    types[0] = types[13] = 3
    out = _rewrite(files[2], tmp_path / "sp.gguf",
                   [("tokenizer.ggml.tokens", toks),
                    ("tokenizer.ggml.token_type", types)])
    jm, tm = load_both(out, "llama")
    n = len(toks)
    view = _tokenizer_view(tm.tokenizer, n)
    assert view == _tokenizer_view(jm.tokenizer, n)
    assert view[10] == b" hello" and view[11] == b"A" and view[12] == b"\n"
    assert view[13] == b"<ctl>" and view[14] == b"  "
    for text in (" hello", "A\n<ctl>", "<t5> hello  A<t7>"):
        assert tm.tokenizer.tokenize(text, True) == \
            jm.tokenizer.tokenize(text, True)


# -- untrusted headers -----------------------------------------------------


def test_v1_rejected(tmp_path):
    p = tmp_path / "old.gguf"
    p.write_bytes(b"GGUF" + struct.pack("<IQQ", 1, 0, 0))
    with pytest.raises(FormatError, match="version"):
        tg.GgufReader(p).load("llama")


def test_corrupt_files_fail_as_the_reference_does(files, tmp_path):
    """Truncations and bit flips: the port parses what the reference
    parses, to the same metadata and index, and fails with a typed error
    where it does."""
    data = files[2].read_bytes()
    rng = random.Random(0)
    p = tmp_path / "fuzz.gguf"
    for trial in range(45):
        buf = bytearray(data)
        mode = trial % 3
        if mode == 0:
            buf = buf[: rng.randrange(0, len(buf))]
        else:
            span = min(len(buf), 512) if mode == 1 else len(buf)
            for _ in range(rng.randrange(1, 8)):
                buf[rng.randrange(0, span)] = rng.randrange(256)
        p.write_bytes(bytes(buf))
        outcome = []
        for mod in (tg, jg):
            try:
                r = mod.GgufReader(p).load("llama")
                outcome.append((r.metadata, list(r.tensors)))
            except (FormatError, jg.FormatError, ValueError, KeyError) as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1], trial


def test_truncated_data_region_fetch_raises(files, tmp_path):
    out = _rewrite(files[2], tmp_path / "short.gguf", drop_tail_bytes=64)
    r = tg.GgufReader(out).load("llama")
    last = max(r.tensors, key=lambda n: r.tensors[n].start_offset)
    with pytest.raises(FormatError, match="exceeds"):
        r.fetch(last)


def test_writer_rejects_foreign_alignment(tmp_path):
    with open(tmp_path / "x.gguf", "wb") as f:
        w = tg.GgufWriter(f)
        w.add_metadata("general.architecture", "llama")
        w.add_metadata("general.alignment", 64)
        with pytest.raises(SaveError, match="alignment"):
            w.finish()


def test_zero_alignment_clean_error(tmp_path):
    buf = io.BytesIO()
    buf.write(tg.GGUF_MAGIC)
    buf.write(struct.pack("<IQQ", 3, 0, 2))
    tg._w_string(buf, b"general.architecture")
    tg._w_value(buf, "llama")
    tg._w_string(buf, b"general.alignment")
    tg._w_value(buf, 0)
    p = tmp_path / "zero.gguf"
    p.write_bytes(buf.getvalue())
    with pytest.raises(FormatError, match="alignment"):
        tg.GgufReader(p).load("llama")
