"""The port's HF converter (llm_tpu_torch.convert_hf and the cli's
`convert-hf`) against the JAX package's (llm_tpu.convert_hf), mirroring
tests/test_convert_hf.py: each tiny random transformers model converts to
a file byte-equal to the reference's (classic GGJT v3 or GGUF v3, f32 or
f16), for all seven architectures (the models of tests/hf_export.py), and
the port's load of it agrees with the transformers forward (the same
tolerances as the reference's test: 2e-3, 2e-2 for f16 storage, 0.12 after
Q8_0); the same inputs are refused with the same ConvertError; the
vocabulary mapping equals the reference's; and the module imports, and an
in-memory conversion runs, with `transformers` hidden (a directory needs
it)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hf_export
import llm_tpu_torch.models.forward as tfwd
from llm_tpu.cli import main as j_main
from llm_tpu.convert_hf import ConvertError as JConvertError
from llm_tpu.convert_hf import convert_hf as j_convert_hf
from llm_tpu.convert_hf import vocab_from_tokenizer as j_vocab
from llm_tpu_torch import loader as tloader
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.convert_hf import ConvertError, convert_hf
from llm_tpu_torch.convert_hf import vocab_from_tokenizer
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
V, E, H, L, F = 96, 64, 4, 2, 128
IDS = np.array([3, 17, 5, 9, 22, 1, 8, 40], dtype=np.int64)


def _ref_logits(hf_model):
    with torch.no_grad():
        return hf_model(torch.tensor(IDS[None])).logits[0].float().numpy()


def _port_logits(path, arch):
    m = tloader.load(path, arch,
                     params=tloader.ModelParameters(context_size=64),
                     device="cpu")
    logits, _, _ = tfwd.forward_step(m.spec, m.params, torch.tensor(IDS), 0,
                                     tfwd.init_cache(m.spec, torch.float32))
    return m, logits.numpy()


def _both(hf, tmp_path, name, **kw):
    """Convert with both packages; the files must be byte-equal."""
    got, want = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
    arch = convert_hf(hf, got, **kw)
    assert j_convert_hf(hf, want, **kw) == arch
    assert got.read_bytes() == want.read_bytes()
    return got, arch


def _parity(path, arch, hf, atol=2e-3):
    m, got = _port_logits(path, arch)
    np.testing.assert_allclose(got, _ref_logits(hf), rtol=atol, atol=atol)
    return m


def _tiny_gpt2():
    from transformers import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(
        vocab_size=V, n_positions=64, n_embd=E, n_layer=L, n_head=H,
        activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    return GPT2LMHeadModel(cfg).eval()


def _llama_gqa():
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=V, hidden_size=E, intermediate_size=F,
        num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=2,
        rms_norm_eps=5e-6, rope_theta=10000.0, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=False,
        max_position_embeddings=64,
    )
    torch.manual_seed(0)
    return LlamaForCausalLM(cfg).eval()


def _falcon(new_arch: bool):
    from transformers import FalconConfig, FalconForCausalLM

    kw = dict(num_kv_heads=2) if new_arch else {}
    cfg = FalconConfig(
        vocab_size=V, hidden_size=E, num_hidden_layers=L,
        num_attention_heads=H, multi_query=False,
        new_decoder_architecture=new_arch, parallel_attn=True, bias=False,
        alibi=False, hidden_dropout=0.0, attention_dropout=0.0, **kw,
    )
    torch.manual_seed(0)
    return FalconForCausalLM(cfg).eval()


def test_convert_gpt2_f32(tmp_path):
    """Conv1D transpose and the tied head left out."""
    hf = _tiny_gpt2()
    path, arch = _both(hf, tmp_path, "gpt2.bin", ftype="f32")
    assert arch == "gpt2"
    _parity(path, "gpt2", hf)


def test_convert_gpt2_f16(tmp_path):
    """ftype f16 stores the 2-D quantizable weights as F16."""
    hf = _tiny_gpt2()
    path, _ = _both(hf, tmp_path, "gpt2_f16.bin", ftype="f16")
    _parity(path, "gpt2", hf, atol=2e-2)


def test_convert_llama_gqa_gguf(tmp_path):
    """GQA LLaMA: q permuted with n_head, k with n_head_kv; the GGUF file
    carries attention.head_count_kv."""
    hf = _llama_gqa()
    path, arch = _both(hf, tmp_path, "llama_gqa.gguf", gguf=True,
                       ftype="f32")
    assert arch == "llama"
    m = _parity(path, "llama", hf)
    assert m.spec.n_head_kv == 2


def test_convert_bloom_qkv_reorder(tmp_path):
    from transformers import BloomConfig, BloomForCausalLM

    cfg = BloomConfig(
        vocab_size=V, hidden_size=E, n_layer=L, n_head=H,
        hidden_dropout=0.0, attention_dropout=0.0,
    )
    torch.manual_seed(0)
    hf = BloomForCausalLM(cfg).eval()
    path, arch = _both(hf, tmp_path, "bloom.bin", ftype="f32")
    assert arch == "bloom"
    _parity(path, "bloom", hf)


def test_convert_falcon40_layout(tmp_path):
    """new_decoder_architecture: per-kv-group qkv to [q x H, k x kv,
    v x kv]."""
    hf = _falcon(new_arch=True)
    path, arch = _both(hf, tmp_path, "falcon40.bin", ftype="f32")
    assert arch == "falcon"
    _parity(path, "falcon", hf)


def test_convert_llama_gqa_classic_raises(tmp_path):
    hf = _llama_gqa()
    with pytest.raises(JConvertError, match="gguf"):
        j_convert_hf(hf, tmp_path / "j.bin", ftype="f32")
    with pytest.raises(ConvertError, match="gguf"):
        convert_hf(hf, tmp_path / "t.bin", ftype="f32")


def test_convert_falcon_old_arch_mha_raises(tmp_path):
    hf = _falcon(new_arch=False)
    with pytest.raises(ConvertError, match="multi_query"):
        convert_hf(hf, tmp_path / "falcon_rw.bin", ftype="f32")
    with pytest.raises(ConvertError, match="unsupported ftype"):
        convert_hf(hf, tmp_path / "x.bin", ftype="q8_0")


class _FakeTok:
    def __init__(self, vocab):
        self._v = vocab

    def get_vocab(self):
        return self._v


@pytest.mark.parametrize("surface", [False, True])
def test_vocab_byte_mapping_bpe(surface):
    tok = _FakeTok({"Ġhello": 0, "hello": 1, "Ċ": 2, "<|endoftext|>": 3})
    vocab = vocab_from_tokenizer(tok, 5, surface=surface)
    assert vocab == j_vocab(tok, 5, surface=surface)
    if surface:
        assert vocab[0][0] == "Ġhello".encode()
    else:
        assert [t for t, _ in vocab] == [b" hello", b"hello", b"\n",
                                         b"<|endoftext|>", b"<unused4>"]


def test_vocab_byte_mapping_sentencepiece():
    tok = _FakeTok({"▁hello": 0, "<0x0A>": 1, "é": 2, "</s>": 3})
    vocab = vocab_from_tokenizer(tok, 4)
    assert vocab == j_vocab(tok, 4)
    assert [t for t, _ in vocab] == [b" hello", b"\n", "é".encode(), b"</s>"]


def test_gguf_sp_vocab_decodes_to_text():
    from llm_tpu.loader import _gguf_sp_token_bytes as j_sp
    from llm_tpu_torch.loader import _gguf_sp_token_bytes

    for tok in ("▁hello".encode(), b"<0x0A>", b"plain"):
        assert _gguf_sp_token_bytes(tok) == j_sp(tok)
    assert _gguf_sp_token_bytes("▁hello".encode()) == b" hello"


def test_convert_from_directory_cli(tmp_path, capsys):
    """The cli's route: save_pretrained, `convert-hf <dir> <out>` (the
    same file and progress lines as the reference cli), parity, then
    `quantize` to Q8_0 and parity at Q8_0's error."""
    hf = _tiny_gpt2()
    src = tmp_path / "hf_model"
    hf.save_pretrained(src)
    out, ref = tmp_path / "t.bin", tmp_path / "j.bin"
    t_main(["convert-hf", str(src), str(out), "--ftype", "f32"])
    t_err = capsys.readouterr().err
    j_main(["convert-hf", str(src), str(ref), "--ftype", "f32"])
    j_err = capsys.readouterr().err
    assert t_err == j_err.replace(str(ref), str(out))
    assert f"wrote {out} (gpt2, f32)" in t_err
    assert out.read_bytes() == ref.read_bytes()
    _parity(out, "gpt2", hf)

    q = tmp_path / "gpt2_q8.bin"
    t_main(["quantize", "-a", "gpt2", str(out), str(q), "q8_0"])
    _parity(q, "gpt2", hf, atol=0.12)


EXPORTERS = ["gpt2", "llama", "gptj", "gptneox", "bloom", "mpt", "falcon",
             "falcon40"]


@pytest.mark.parametrize("name", EXPORTERS)
def test_convert_every_architecture(tmp_path, name):
    """Every `_conv_*` stream, on tests/hf_export.py's models: byte-equal
    files in both containers and storage types, and the port's f32 load
    against transformers."""
    hf = getattr(hf_export, f"export_{name}")(tmp_path / "export.bin")
    path, arch = _both(hf, tmp_path, "f32.bin", ftype="f32")
    _both(hf, tmp_path, "f16.gguf", ftype="f16", gguf=True)
    _parity(path, arch, hf)


def test_imports_without_transformers(tmp_path):
    """The module imports, and an in-memory conversion runs, with
    transformers hidden; a directory then needs it."""
    code = f"""
import sys
sys.modules["transformers"] = None
import torch
from llm_tpu_torch.convert_hf import convert_hf, placeholder_vocab

class Cfg:
    model_type = "gpt2"; vocab_size = 8; n_positions = 16; n_embd = 32
    n_head = 2; n_layer = 1

class Model:
    config = Cfg()
    def state_dict(self):
        g = torch.Generator().manual_seed(0)
        r = lambda *s: torch.randn(*s, generator=g)
        sd = {{"transformer.wte.weight": r(8, 32),
              "transformer.wpe.weight": r(16, 32),
              "transformer.ln_f.weight": r(32), "transformer.ln_f.bias": r(32)}}
        p = "transformer.h.0."
        for n, s in (("ln_1.weight", (32,)), ("ln_1.bias", (32,)),
                     ("ln_2.weight", (32,)), ("ln_2.bias", (32,)),
                     ("attn.c_attn.weight", (32, 96)), ("attn.c_attn.bias", (96,)),
                     ("attn.c_proj.weight", (32, 32)), ("attn.c_proj.bias", (32,)),
                     ("mlp.c_fc.weight", (32, 128)), ("mlp.c_fc.bias", (128,)),
                     ("mlp.c_proj.weight", (128, 32)), ("mlp.c_proj.bias", (32,))):
            sd[p + n] = r(*s)
        return sd
    def get_output_embeddings(self):
        return None  # tied: the converter leaves the head out
    def get_input_embeddings(self):
        return None

assert placeholder_vocab(2) == [(b"<unused0>", 0.0), (b"<unused1>", 0.0)]
assert convert_hf(Model(), {str(tmp_path / 'm.bin')!r}, ftype="f32") == "gpt2"
try:
    convert_hf({str(tmp_path)!r}, {str(tmp_path / 'n.bin')!r})
except ImportError:
    print("needs transformers")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "needs transformers"
    assert (tmp_path / "m.bin").stat().st_size > 0
