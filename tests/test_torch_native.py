"""The port's counterpart of `llm_tpu/native/` (llm_tpu_torch.native, the
codec kernel csrc/codecs.cu) and the load path around it, on the CPU.

The kernel runs only on the card (`chip_smoke.py` holds it bit-equal to
its plain version and to the host decode there). Here: the plain version
(`ops/packing.decode_plain`: `_decode_scalar` and `_decode_kquant`) is
bit-equal to the JAX package's `ggml/quant.decode_blocks` for all ten
formats, edge blocks included; the port's `pack_ggml` to the reference's;
`decode_ggml` dispatches a CUDA tensor to `native.decode` and never
reaches the numpy decoder; `native.decode` refuses a CPU tensor; a load
decodes each quantized matrix once.

Tolerance: none. The decode is integer and exact f16 -> f32 arithmetic in
every implementation (each scale product is exact in f32), so q, scale and
bias are compared bit for bit."""

import numpy as np
import pytest
import torch

from llm_tpu.ggml.quant import decode_blocks as ref_decode_blocks
from llm_tpu.ggml.quant import quantize
from llm_tpu.ggml.types import GgmlType, block_size, type_size
from llm_tpu.ops import packing as jpk
from llm_tpu_torch import loader, native
from llm_tpu_torch.ggml import quant as tquant
from llm_tpu_torch.models import params as tparams
from llm_tpu_torch.ops import packing as tpk
from llm_tpu_torch.testing import (
    _F16_FIELDS,
    EDGE_F16,
    codec_blocks,
    make_tiny_file,
)

ALL_TYPES = [GgmlType.Q4_0, GgmlType.Q4_1, GgmlType.Q5_0, GgmlType.Q5_1,
             GgmlType.Q8_0, GgmlType.Q2_K, GgmlType.Q3_K, GgmlType.Q4_K,
             GgmlType.Q5_K, GgmlType.Q6_K]
K_QUANTS = ALL_TYPES[5:]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_blocks(t: GgmlType, n: int, seed: int) -> bytes:
    """Random valid blocks from a seed, made as tests/test_native.py's
    `_random_blocks` makes them: the real quantizer for the 32-block
    formats; for the K-quants random bytes with small f16 scale fields."""
    rng = np.random.default_rng(seed)
    if t not in K_QUANTS:
        return quantize(t, rng.standard_normal(n, dtype=np.float32))
    nb = n // block_size(t)
    raw = rng.integers(0, 256, size=(nb, type_size(t)), dtype=np.uint8)
    d16 = np.float16(rng.uniform(0.001, 0.1, size=nb)).view(
        np.uint8).reshape(nb, 2)
    for o in _F16_FIELDS[t]:
        raw[:, o:o + 2] = d16
    return raw.tobytes()


def ref_triple(t, raw, K, R):
    """The reference's decode as (q, scale, bias) numpy arrays [R, ...]."""
    dec = ref_decode_blocks(t, raw, K * R)
    return tuple(None if a is None else
                 np.ascontiguousarray(a, dtype).reshape(R, -1)
                 for a, dtype in ((dec.q, np.int32), (dec.scale, np.float32),
                                  (dec.bias, np.float32)))


def assert_bits_equal(got, want):
    for name, g, w in zip(("q", "scale", "bias"), got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=name)


# -- the plain decode against the reference --------------------------------


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_plain_decode_bit_equal(t):
    for i, (nbk, R) in enumerate([(2, 9), (1, 1), (3, 5)]):
        K = nbk * block_size(t)
        raw = random_blocks(t, K * R, seed=i)
        want = ref_triple(t, raw, K, R)
        assert_bits_equal(tpk.decode_ggml(t, raw, K, R, "cpu"), want)
        raw_t = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
        assert_bits_equal(tpk.decode_plain(t, raw_t, K, R), want)


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_edge_blocks_bit_equal(t):
    """d 0, -0, negative, subnormal (smallest, mid, negative), and for the
    K-quants scale bytes all 0xFF (6-bit scales and mins 63), 0x80 (Q6_K's
    -128) and 0x7F."""
    K, R = 2 * block_size(t), 12
    raw = codec_blocks(t, K, R, np.random.default_rng(5), edges=True)
    want = ref_triple(t, raw.tobytes(), K, R)
    got = tpk.decode_ggml(t, raw, K, R, "cpu")
    assert_bits_equal(got, want)
    # the edges are there: block 3's d is the smallest f16 subnormal, and
    # a Q6_K block 7 has every scale byte 0x80 (-128)
    scales = got[1].reshape(-1, block_size(t) // tpk.FORMATS[t].gsize)
    assert EDGE_F16[3] == 0x0001
    if t == GgmlType.Q4_0:
        assert scales[3, 0].item() == 2.0**-24
    if t == GgmlType.Q6_K:
        d = raw.reshape(-1, type_size(t))[7, 208:210].copy().view(
            np.float16)[0]
        assert (scales[7] == np.float32(d) * -128).all()


# -- the port's pack_ggml against the reference's ---------------------------


@pytest.mark.parametrize("rows", [None, "select"])
@pytest.mark.parametrize("t", K_QUANTS, ids=lambda t: t.name)
def test_pack_ggml_kquants_at_k11008(t, rows):
    K, R = 11008, 12
    raw = random_blocks(t, K * R, seed=11)
    sel = (np.array([11, 0, 5, 5, 7, 2, 9]) if rows == "select" else None)
    tq = tpk.pack_ggml(t, raw, (K, R), rows=sel)
    jq = jpk.pack_ggml(t, raw, (K, R), rows=sel)
    assert (tq.k, tq.r, tq.k_padded, tq.r_padded) == \
        (jq.k, jq.r, jq.k_padded, jq.r_padded)
    for name in ("lo", "hi", "scale", "bias"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is not None:
            b = np.asarray(b)
            a = a.numpy().view(b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- the dispatch -------------------------------------------------------------


def test_decode_ggml_never_reaches_numpy(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("the load path reached the numpy decoder")

    monkeypatch.setattr(tquant, "decode_blocks", refuse)
    for t in list(tquant._DECODE):
        monkeypatch.setitem(tquant._DECODE, t, refuse)
    assert not hasattr(tpk, "decode_blocks")
    for t in ALL_TYPES:
        K, R = block_size(t), 3
        tpk.pack_ggml(t, random_blocks(t, K * R, seed=2), (K, R),
                      rows=np.array([2, 0]))
    path = tmp_path / "mpt.bin"
    make_tiny_file("mpt", path, GgmlType.Q4_K, n_embd=256)
    model = loader.load(path, "mpt", device="cpu")
    assert model.params.layers.w_qkv.fmt_name == "q4_k"


class _CudaBytes:
    """Stands in for raw bytes on a CUDA device (`is_cuda`), carrying the
    host tensor the recorder decodes."""

    is_cuda = True

    def __init__(self, raw):
        self.raw = raw


@pytest.mark.parametrize("t", ALL_TYPES, ids=lambda t: t.name)
def test_cuda_tensor_takes_the_kernel(t, monkeypatch):
    """On a CUDA device decode_ggml hands the bytes to native.decode for
    every format, and never to the plain version or the numpy decoder."""
    calls = []
    real_raw_bytes = tpk.raw_bytes

    class HostBytes:  # what raw_bytes returns; .to() "moves" it
        def __init__(self, host):
            self.host = host

        def to(self, device):
            calls.append(str(device))
            return _CudaBytes(self.host)

    def raw_bytes(*a):
        return HostBytes(real_raw_bytes(*a))

    def kernel(tt, raw, K, R):  # the kernel's result: the reference's
        assert isinstance(raw, _CudaBytes)
        calls.append(("native", tt, K, R))
        return tuple(None if a is None else torch.from_numpy(a) for a in
                     ref_triple(tt, raw.raw.numpy().tobytes(), K, R))

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a host decoder")

    monkeypatch.setattr(tpk, "raw_bytes", raw_bytes)
    monkeypatch.setattr(native, "decode", kernel)
    monkeypatch.setattr(tpk, "decode_plain", refuse)
    monkeypatch.setattr(tpk, "_decode_scalar", refuse)
    monkeypatch.setattr(tpk, "_decode_kquant", refuse)
    monkeypatch.setattr(tquant, "decode_blocks", refuse)
    K, R = 2 * block_size(t), 4
    raw = random_blocks(t, K * R, seed=4)
    got = tpk.decode_ggml(t, raw, K, R, "cuda:0")
    assert calls == ["cuda:0", ("native", t, K, R)]
    assert_bits_equal(got, ref_triple(t, raw, K, R))


def test_native_decode_refuses_a_cpu_tensor():
    t = GgmlType.Q4_K
    K, R = 256, 2
    raw = torch.from_numpy(np.frombuffer(random_blocks(t, K * R, seed=1),
                                         np.uint8).copy())
    launches = native.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        native.decode(t, raw, K, R)
    with pytest.raises(NotImplementedError):
        native.decode(GgmlType.F16, raw, K, R)
    assert native.LAUNCHES == launches


@pytest.mark.parametrize("arch,t", [
    ("llama", GgmlType.Q4_0), ("mpt", GgmlType.Q4_K),
    ("gpt2", GgmlType.Q8_0), ("gptj", GgmlType.Q5_K),
    ("gptneox", GgmlType.Q6_K), ("bloom", GgmlType.Q3_K),
    ("falcon", GgmlType.Q2_K)])
def test_load_decodes_each_quantized_matrix_once(arch, t, tmp_path,
                                                 monkeypatch):
    """What chip_smoke.load_record holds on the card (the codec kernel's
    launches equal the quantized matrices a load packs): each quantized
    tensor is decoded once, a fused q|k|v's row selections included."""
    decoded = []
    real = tpk.decode_ggml

    def counted(tt, data, K, R, device):
        decoded.append((tt, K, R))
        return real(tt, data, K, R, device)

    monkeypatch.setattr(tpk, "decode_ggml", counted)
    monkeypatch.setattr(tparams, "decode_ggml", counted)
    path = tmp_path / f"{arch}.bin"
    make_tiny_file(arch, path, t, n_embd=256)
    loader.load(path, arch, device="cpu")
    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.models.spec import get_arch

    spec_arch = get_arch(arch)
    reader = GgmlReader(path).load(
        lambda f: (lambda h: (h, h.n_vocab))(spec_arch.read_hparams(f)))
    quantized = [i for i in reader.tensors.values()
                 if i.element_type.is_quantized]
    assert sorted(decoded) == sorted(
        (i.element_type, i.dims[0], i.dims[1]) for i in quantized)
