"""The port's quantizer (llm_tpu_torch.quantize and the cli's `quantize`)
against the JAX package's (llm_tpu.quantize), mirroring
tests/test_cli.py:49, 72 and tests/test_gguf.py:201-282: for each of the
ten targets and each of the three containers (GGML, GGJT v3, GGUF v3) the
port writes a file byte-equal to the reference's from the same f16 tiny
LLaMA (n_embd 256, so the K-quants meet both whole and fallback rows), with
the same progress events; a GGUF source passes its metadata through to a
GGUF destination and converts back to the classic container byte-equal;
the cli's progress lines equal the reference cli's, and its output infers
the reference cli's greedy text."""

import numpy as np
import pytest

from llm_tpu.cli import main as j_main
from llm_tpu.ggml.gguf import convert_ggml_to_gguf
from llm_tpu.ggml.types import ContainerType
from llm_tpu.ggml.types import GgmlType as JGgmlType
from llm_tpu.quantize import quantize as j_quantize
from llm_tpu.testing import make_tiny_file
from llm_tpu_torch.cli import main as t_main
from llm_tpu_torch.ggml.gguf import GgufReader, is_gguf
from llm_tpu_torch.ggml.reader import GgmlReader
from llm_tpu_torch.ggml.types import ContainerType as TContainerType
from llm_tpu_torch.ggml.types import GgmlType
from llm_tpu_torch.models.spec import get_arch
from llm_tpu_torch.quantize import VALID_TARGETS, QuantizeError, quantize
from test_torch_archs import one_torch_thread  # noqa: F401 (autouse)

TARGETS = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
           "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"]
CONTAINERS = {"ggml": (("ggml",), ".bin"), "ggjt": (("ggjt", 3), ".bin"),
              "gguf": (("gguf", 3), ".gguf")}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """(classic f16 file, its GGUF conversion)."""
    d = tmp_path_factory.mktemp("torch_quantize")
    src = d / "f16.bin"
    make_tiny_file("llama", src, JGgmlType.F16, n_embd=256)
    gguf = d / "f16.gguf"
    convert_ggml_to_gguf(src, gguf, "llama")
    return src, gguf


def _events(log):
    def ev(e):
        return (e.kind, e.name,
                None if e.element_type is None else int(e.element_type),
                tuple(e.dims), e.original_size, e.reduced_size,
                None if e.history is None else tuple(int(h) for h in
                                                     e.history))
    return [ev(e) for e in log]


def _classic(path):
    arch = get_arch("llama")
    return GgmlReader(path).load(
        lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f)))


@pytest.mark.parametrize("container", list(CONTAINERS))
@pytest.mark.parametrize("target", TARGETS)
def test_quantize_byte_equal(sources, tmp_path, target, container):
    src, _ = sources
    args, suffix = CONTAINERS[container]
    got, want = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    tlog, jlog = [], []
    quantize(src, got, "llama", GgmlType[target.upper()],
             container=TContainerType(*args), progress=tlog.append)
    j_quantize(src, want, "llama", JGgmlType[target.upper()],
               container=ContainerType(*args), progress=jlog.append)
    assert got.read_bytes() == want.read_bytes()
    assert _events(tlog) == _events(jlog)
    kinds = [e.kind for e in tlog]
    assert kinds[0] == "hyperparameters_loaded" and kinds[-1] == "finished"
    assert "tensor_quantized" in kinds and "tensor_skipped" in kinds
    # the K-quants fall back to Q8_0 where a row is not a whole superblock
    types = {e.element_type for e in tlog if e.kind == "tensor_quantized"}
    if target.endswith("_k"):
        assert GgmlType[target.upper()] in types
    else:
        assert types == {GgmlType[target.upper()]}
    assert is_gguf(got) == (container == "gguf")


@pytest.mark.parametrize("target,suffix", [("q5_1", ".gguf"),
                                           ("q8_0", ".bin")],
                         ids=["gguf_to_gguf", "gguf_to_classic"])
def test_quantize_gguf_source(sources, tmp_path, target, suffix):
    """GGUF -> GGUF keeps every metadata key but general.file_type and
    the GGUF tensor names; GGUF -> GGJT gives the classic source's
    quantization. Both byte-equal to the reference's."""
    src, gguf = sources
    got, want = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    quantize(gguf, got, "llama", GgmlType[target.upper()])
    j_quantize(gguf, want, "llama", JGgmlType[target.upper()])
    assert got.read_bytes() == want.read_bytes()
    if suffix == ".gguf":
        a, b = GgufReader(gguf).load("llama"), GgufReader(got).load("llama")
        md_a, md_b = dict(a.metadata), dict(b.metadata)
        md_a.pop("general.file_type")
        assert md_b.pop("general.file_type") != 0
        assert md_a == md_b
        assert "blk.0.attn_q.weight" in b.source_names.values()
    else:
        ref = tmp_path / "from_classic.bin"
        quantize(src, ref, "llama", GgmlType[target.upper()])
        assert got.read_bytes() == ref.read_bytes()


def test_invalid_target_refused(sources, tmp_path):
    assert len(VALID_TARGETS) == 10
    with pytest.raises(QuantizeError, match="invalid quantization target"):
        quantize(sources[0], tmp_path / "x.bin", "llama", GgmlType.F16)


@pytest.mark.parametrize("target", ["q5_1", "q4_k"])
def test_cli_quantize_then_infer(sources, tmp_path, capsys, target):
    """tests/test_cli.py:49, 72: the cli's file holds the target type
    (Q8_0 where a K-quant row does not fit), the norms stay f32, the
    quantization version is 2, and infer runs it; progress lines and the
    greedy text equal the reference cli's."""
    src, _ = sources
    got, want = tmp_path / "t.bin", tmp_path / "j.bin"
    t_main(["quantize", "-a", "llama", str(src), str(got), target])
    t_err = capsys.readouterr().err
    j_main(["quantize", "-a", "llama", str(src), str(want), target])
    j_err = capsys.readouterr().err
    assert t_err == j_err and "Finished quantization from" in t_err
    assert got.read_bytes() == want.read_bytes()

    r = _classic(got)
    assert r.tensors["layers.0.attention.wq.weight"].element_type == \
        GgmlType[target.upper()]
    assert r.tensors["norm.weight"].element_type == GgmlType.F32
    ffn = r.tensors["layers.0.feed_forward.w2.weight"]
    if target == "q4_k":
        assert ffn.element_type == (GgmlType.Q4_K if ffn.dims[0] % 256 == 0
                                    else GgmlType.Q8_0)
    assert r.hyperparameters.file_type.quantization_version == 2

    args = ["infer", "-m", str(got), "-a", "llama", "-p", "<t2><t3>", "-n",
            "6", "-s", "topk:k=1", "--ignore-eos", "--num-ctx-tokens", "64"]
    j_main(args)
    want_out = capsys.readouterr().out
    t_main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out == want_out and "<t2>" in out


def test_cli_quantize_gguf_destination(tmp_path, capsys):
    src = tmp_path / "m.bin"
    dst = tmp_path / "m.q4_0.gguf"
    make_tiny_file("llama", src)
    t_main(["quantize", str(src), str(dst), "q4_0", "-a", "llama"])
    assert is_gguf(dst)
    t_main(["info", "-m", str(dst), "-a", "llama"])
    assert "q4_0" in capsys.readouterr().out.lower()
    # without an architecture the cli refuses before reading anything
    with pytest.raises(SystemExit):
        t_main(["quantize", str(src), str(tmp_path / "y.bin"), "q4_0"])
    assert "architecture must be known" in capsys.readouterr().err
    assert not np.any([p.name == "y.bin" for p in tmp_path.iterdir()])
