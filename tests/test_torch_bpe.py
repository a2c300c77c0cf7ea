"""The port's byte-level BPE tokenizer (`llm_tpu_torch/tokenizer/bpe.py`)
against the JAX package's and transformers' GPT2Tokenizer, built from the
same vocabulary and merges (tests/test_bpe.py's cases): the same ids, the
same bytes back, `bytes_to_unicode` equal; and a GGUF file with
`tokenizer.ggml.model` = gpt2 and merges loaded by both packages: the BPE
path, the same ids, greedy tokens through the cli equal. Ids and bytes
are compared exactly."""

import json

import pytest
from test_bpe import _build_vocab
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

from llm_tpu.cli import main as j_main
from llm_tpu.ggml.gguf import GgufWriter, gguf_name_fn
from llm_tpu.ggml.reader import GgmlReader
from llm_tpu.loader import ModelParameters as JModelParameters
from llm_tpu.loader import load as j_load
from llm_tpu.models.spec import get_arch
from llm_tpu.testing import make_tiny_file
from llm_tpu.tokenizer import bpe as jbpe
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.tokenizer import bpe as tbpe

TEXTS = [
    "hello world",
    " hello  world ",
    "hello, world! don't stop",
    "a_b __ c",
    "123 12 3",
    "tabs\tand\nnewlines",
    "héllo wörld",  # multibyte utf-8
    "x" * 40,
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    tokens, merges = _build_vocab()
    raw = [t.encode() for t in tokens]
    from transformers import GPT2Tokenizer

    d = tmp_path_factory.mktemp("torch_bpe")
    (d / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(tokens)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                  + "\n")
    hf = GPT2Tokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
    return (tbpe.BpeTokenizer(raw, merges), jbpe.BpeTokenizer(raw, merges),
            hf)


def test_bytes_to_unicode_equal():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()


@pytest.mark.parametrize("text", TEXTS)
def test_ids_and_bytes_match(tokenizers, text):
    mine, ref, hf = tokenizers
    got = mine.tokenize(text, bos=False)
    assert got == ref.tokenize(text, bos=False)
    ids = [tid for _, tid in got]
    assert ids == hf.encode(text)
    assert mine.decode(ids, False) == ref.decode(ids, False) == \
        text.encode("utf-8")


def test_token_surface(tokenizers):
    mine, ref, _ = tokenizers
    assert len(mine) == len(ref) == 256 + 13
    assert [mine.token(i) for i in range(len(mine))] == \
        [ref.token(i) for i in range(len(ref))]
    assert mine.token(ord("!")) == b"!" and mine.id(b"!") == ord("!")


@pytest.fixture(scope="module")
def bpe_gguf(tmp_path_factory):
    """A tiny GPT-2 in GGUF with a gpt2 BPE vocabulary: 269 tokens and
    GPT-2's end of text, a control token."""
    d = tmp_path_factory.mktemp("torch_bpe_gguf")
    ggjt = d / "gpt2.bin"
    make_tiny_file("gpt2", ggjt, n_vocab=270)
    src = GgmlReader(ggjt).load(
        lambda f: (lambda h: (h, h.n_vocab))(get_arch("gpt2").read_hparams(f))
    )
    tokens, merges = _build_vocab()
    tokens = tokens + ["<|endoftext|>"]
    to_gguf = gguf_name_fn("gpt2")
    h = src.hyperparameters
    out = d / "gpt2.gguf"
    with open(out, "wb") as f:
        w = GgufWriter(f)
        w.add_metadata("general.architecture", "gpt2")
        w.add_metadata("gpt2.embedding_length", h.n_embd)
        w.add_metadata("gpt2.block_count", h.n_layer)
        w.add_metadata("gpt2.attention.head_count", h.n_head)
        w.add_metadata("gpt2.context_length", h.n_ctx)
        w.add_metadata("general.file_type", 0)
        w.add_metadata("tokenizer.ggml.model", "gpt2")
        w.add_metadata("tokenizer.ggml.tokens", tokens)
        w.add_metadata("tokenizer.ggml.merges", merges)
        w.add_metadata("tokenizer.ggml.token_type", [1] * 269 + [3])
        w.add_metadata("tokenizer.ggml.bos_token_id", 3)
        for name, info in src.tensors.items():
            w.add_tensor(to_gguf(name), info.element_type, info.dims,
                         bytes(src.fetch(name)))
        w.finish()
    return out


def test_gguf_bpe_loader(bpe_gguf):
    jm = j_load(bpe_gguf, "gpt2", params=JModelParameters(context_size=64))
    tm = tloader.load(bpe_gguf, "gpt2",
                      params=tloader.ModelParameters(context_size=64),
                      device="cpu")
    assert isinstance(tm.tokenizer.inner, tbpe.BpeTokenizer)
    assert not tm.tokenizer.is_embedded
    for text in TEXTS + [" hello world"]:
        for bos in (False, True):
            assert tm.tokenizer.tokenize(text, bos) == \
                jm.tokenizer.tokenize(text, bos)
    ids = [tid for _, tid in tm.tokenizer.tokenize(" hello world", False)]
    assert len(ids) == 2  # " hello" and " world" are learned tokens
    assert tm.tokenizer.decode(ids, False) == b" hello world"


def test_cli_infer_on_bpe_gguf(bpe_gguf, capsys):
    """Greedy text through the cli on the BPE file: the diff-decoded
    pieces of a non-embedded tokenizer, as the reference prints them."""
    argv = ["infer", "-m", str(bpe_gguf), "-a", "gpt2", "-p",
            " hello world", "-n", "6", "-s", "topk:k=1", "--ignore-eos",
            "--num-ctx-tokens", "64"]
    j_main(argv)
    ref = capsys.readouterr().out
    t_main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == ref
