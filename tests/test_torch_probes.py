"""The port's chip probes (llm_tpu_torch.probes) and their kernels' plain
versions (llm_tpu_torch.ops.qmatmul_probe) on the CPU.

- P3 modes: each mode's plain version against the reference probe's own
  kernel for the same mode (`scripts/probe_dequant_variants.make_call`, run
  in Pallas interpret mode by patching `pallas_call`), at K=1024, R=512
  (packed to 1024), L=2, layer 1. Both sides are f32 on the CPU and sum in
  other orders: rtol 1e-5 and atol 1e-5 of max|y| (nounpack's weights reach
  ~1e6, so its sums cancel). `gdot` and `dimsem` are held as the port runs
  them, as ghoist and base. The reference's `stream` mode returns x[0, 0]
  plus 1e-30 times a sum, which is no number worth matching: the port's
  stream checksum is held to a direct numpy computation of its definition
  instead (the stage tests below, coalesced q4_0).
- P2 stages: stream and unpack (exact integer checksums) and dequant (an
  f32 sum over K, held to 1e-5 of the sum of |w|) against numpy
  computations of their definitions from the reference's own decoding and
  buffers, for q4_0, q8_0 and q6_k over planes and coalesced buffers. The
  reference's stage kernels (`make_probe`) write a max over 8 elements that
  only kept their loads alive, which is not the port's checksum, so they
  are not compared. `full` is qmatmul's plain version.
- P1: every coalesced variant's plain output equals the plane variant's,
  bit for bit (the same dequantized values, the same product).
- The entry points run at a tiny size with `--device cpu` and print their
  table and JSON line; without `--device` they ask for the card."""

import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from llm_tpu.ggml.quant import decode_blocks
from llm_tpu.ggml.types import GgmlType
from llm_tpu.ops import packing as jpk
from llm_tpu_torch.ops import packing as tpk
from llm_tpu_torch.ops import qmatmul as tqm
from llm_tpu_torch.ops import qmatmul_probe as qp
from llm_tpu_torch.probes import coalesced as p1
from llm_tpu_torch.probes import common
from llm_tpu_torch.probes import dequant_variants as p3
from llm_tpu_torch.probes import kernel_decompose as p2
from test_torch_packing import random_raw

REPO = Path(__file__).resolve().parent.parent


def _reference_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_dequant_variants", REPO / "scripts" / "probe_dequant_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def p3_weights():
    """One stacked q4_0 weight (2 layers of distinct bytes) coalesced whole
    K x 512 lanes by both packages, and x [8, K]."""
    t, K, R, L = GgmlType.Q4_0, 1024, 512, 2
    raws = [random_raw(t, K, R, seed=60 + l) for l in range(L)]
    jqs = [jpk.pack_ggml(t, raw, (K, R), r_multiple=1024) for raw in raws]
    tqs = [tpk.pack_ggml(t, raw, (K, R), r_multiple=1024) for raw in raws]
    js = jpk.QuantTensor("q4_0", K, R, jnp.stack([q.lo for q in jqs]), None,
                         jnp.stack([q.scale for q in jqs]), None)
    ts = tpk.QuantTensor("q4_0", K, R, torch.stack([q.lo for q in tqs]), None,
                         torch.stack([q.scale for q in tqs]), None)
    x = np.random.default_rng(61).standard_normal((8, K)).astype(np.float32)
    return (jpk.coalesce_qt(js, js.k_padded, 512),
            tpk.coalesce_qt(ts, ts.k_padded, 512), x)


@pytest.mark.parametrize("mode", ["base", "bf16", "f32dot", "ghoist", "gdot",
                                  "noscale", "nounpack", "dimsem"])
def test_mode_plain_matches_reference_probe(mode, p3_weights, monkeypatch):
    jqc, tqc, x = p3_weights
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    ref = np.asarray(_reference_probe().make_call(jqc, mode)(
        jnp.asarray(x), jqc, 1))[:, : jqc.r]
    launches = qp.LAUNCHES
    got = qp.mode_run(torch.from_numpy(x), tqc.layer(1),
                      p3.ALIASES.get(mode, mode)).numpy()
    assert qp.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    assert got.shape == ref.shape == (8, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


# -- stages -------------------------------------------------------------------

STAGE_TYPES = [GgmlType.Q4_0, GgmlType.Q8_0, GgmlType.Q6_K]


def _u32_sum(a, axis) -> np.ndarray:
    return a.astype(np.int64).sum(axis=axis)


def _numpy_stage(stage, t, raw, K, R, jq, jqc) -> np.ndarray:
    """A stage's value for each column, from the reference's decoding (and,
    for stream, the words the reference's planes or buffer hold)."""
    Kp, Rp = jq.k_padded, jq.r_padded
    dec = decode_blocks(t, raw, K * R)
    g = dec.gsize
    q = np.zeros((Kp, Rp), np.int64)
    q[:K, :R] = dec.q.reshape(R, K).T
    scale = np.zeros((Kp // g, Rp), np.float32)
    scale[: K // g, :R] = np.asarray(dec.scale, np.float32).reshape(R, -1).T
    bias = None
    if dec.bias is not None:
        bias = np.zeros_like(scale)
        bias[: K // g, :R] = np.asarray(dec.bias, np.float32).reshape(R, -1).T
    if stage == "dequant":
        w = (q - dec.zero).astype(np.float32) * np.repeat(scale, g, axis=0)
        if bias is not None:
            w = w + np.repeat(bias, g, axis=0)
        return w.astype(ml_dtypes.bfloat16).astype(np.float64).sum(axis=0)
    reads = 2 if jq.scale_packed else 1
    if stage == "unpack":  # the field as stored: q4_0's is q - 8
        field = q - (dec.zero if t == GgmlType.Q4_0 else 0)
        words = [np.asarray(p).view(np.uint32) for p in (jq.scale, jq.bias)
                 if p is not None]
        s = field.sum(axis=0) + reads * sum(_u32_sum(p, 0) for p in words)
    elif jqc is None:  # stream over planes
        lo = np.asarray(jq.lo)
        s = _u32_sum(lo if lo.dtype == np.int8 else lo.view(np.uint32), 0)
        for p, n in ((jq.hi, 1), (jq.scale, reads), (jq.bias, reads)):
            if p is not None:
                s = s + n * _u32_sum(np.asarray(p).view(np.uint32), 0)
    else:  # stream over the buffer: every row of each block, scale x reads
        lo_r, hi_r, sc_r, b_r = jqc.seg_rows
        n_r, n_k = jqc.rp // jqc.tile_r, jqc.kp // jqc.tile_k
        b = np.asarray(jqc.buf).reshape(n_r, n_k, -1, jqc.tile_r)
        wts = np.array([1] * (lo_r + hi_r) + [reads] * (sc_r + b_r))
        s = (_u32_sum(b, 1) * wts[None, :, None]).sum(axis=1).reshape(-1)
    return (s & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("layout", ["planes", "coalesced"])
@pytest.mark.parametrize("t", STAGE_TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("stage", list(qp.STAGES))
def test_stage_plain_matches_numpy(stage, t, layout):
    K, R = 1024, 200  # two k-tiles and two r-tiles when coalesced
    raw = random_raw(t, K, R, seed=70)
    jq = jpk.pack_ggml(t, raw, (K, R))
    tq = tpk.pack_ggml(t, raw, (K, R))
    jqc, w = None, tq
    if layout == "coalesced":
        jqc = jpk.coalesce_qt(jq, 512, 128, to_device=False)
        w = tpk.coalesce_qt(tq, 512, 128)
    launches = qp.LAUNCHES
    got = qp.stage_run(w, stage).numpy()
    assert qp.LAUNCHES == launches
    assert got.shape == (tq.r_padded,)
    want = _numpy_stage(stage, t, raw, K, R, jq, jqc)
    if stage == "dequant":
        w_abs = np.abs(tpk.dequant(tq, trim=False).numpy()).sum(axis=0)
        assert (np.abs(got - want) <= 1e-5 * w_abs).all()
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want)


def test_stage_kernels_refuse_other_formats():
    tq = tpk.pack_ggml(GgmlType.Q5_1, random_raw(GgmlType.Q5_1, 256, 128, 1),
                       (256, 128))
    with pytest.raises(ValueError, match="stage kernels take"):
        qp.prepare_stage(tq, "stream", 8)
    with pytest.raises(ValueError, match="coalesced q4_0"):
        qp.prepare_mode(torch.zeros((8, 256)), tq, "base")


def _q4_0(K=512, R=256, seed=2):
    return tpk.pack_ggml(GgmlType.Q4_0,
                         random_raw(GgmlType.Q4_0, K, R, seed), (K, R))


@pytest.mark.parametrize("case", [
    "f32_scales_planes", "f32_scales_coalesced", "q5_0_coalesced",
    "q4_k_planes", "unknown_stage"])
def test_stage_entry_points_refuse(case):
    """The cuts are built for q4_0 and q8_0 with f16-packed scales and
    q6_k, over planes or a coalesced buffer; anything else is refused
    before a launch (here, where there is no card)."""
    x = torch.zeros((8, 512))
    stage = "stream"
    if case.startswith("f32_scales"):
        w = tpk.unpack_scales_qt(_q4_0())
    elif case == "q5_0_coalesced":
        w = tpk.pack_ggml(GgmlType.Q5_0,
                          random_raw(GgmlType.Q5_0, 512, 256, 3), (512, 256))
    elif case == "q4_k_planes":
        w = tpk.pack_ggml(GgmlType.Q4_K,
                          random_raw(GgmlType.Q4_K, 512, 256, 4), (512, 256))
    else:
        w, stage = _q4_0(), "full"
    if case.endswith("coalesced"):
        w = tpk.coalesce_qt(w, 512, 128)
    match = "unknown stage" if stage == "full" else "stage kernels take"
    with pytest.raises(ValueError, match=match):
        qp.stage_buffers(w, stage, x, 132)
    with pytest.raises(ValueError, match=match):
        qp.prepare_stage(w, stage, 8, x)


@pytest.mark.parametrize("case", [
    "planes", "f32_scales", "q8_0", "M16", "M512", "unknown_mode"])
def test_mode_entry_points_refuse(case):
    """The modes take a coalesced q4_0 buffer with f16-packed scales, on
    the swapped path at 8 tokens a block (M <= 8)."""
    w, M, mode = _q4_0(), 8, "bf16"
    match = "coalesced q4_0"
    if case == "f32_scales":
        w = tpk.unpack_scales_qt(w)
    elif case == "q8_0":
        w = tpk.pack_ggml(GgmlType.Q8_0,
                          random_raw(GgmlType.Q8_0, 512, 256, 5), (512, 256))
    elif case in ("M16", "M512"):
        M, match = int(case[1:]), "8 tokens a block"
    elif case == "unknown_mode":
        mode, match = "fp8", "unknown mode"
    if case != "planes":
        w = tpk.coalesce_qt(w, 512, 128)
    x = torch.zeros((M, 512))
    with pytest.raises(ValueError, match=match):
        qp.mode_buffers(x, w, mode, 132)
    if case not in ("M16", "M512"):  # these reach the card's properties
        with pytest.raises(ValueError, match=match):
            qp.prepare_mode(x, w, mode)


@pytest.mark.parametrize("module", [
    "llm_tpu_torch.ops.qmatmul_probe", "llm_tpu_torch.probes.coalesced",
    "llm_tpu_torch.probes.kernel_decompose",
    "llm_tpu_torch.probes.dequant_variants",
    "llm_tpu_torch.probes.kernel_report"])
def test_probe_module_imports_neither_jax_nor_the_reference(module):
    code = (f"import sys\nimport {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'llm_tpu')]\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_full_variant_is_qmatmul_plain():
    w = common.random_q4_0(256, 256, 3, "cpu")
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(4))
    assert torch.equal(p2.variant_plain("full", x, w),
                       tqm.qmatmul_plain(x, w))


def test_p1_coalesced_variants_equal_plane():
    weights = p1.build(4096, 640, 0, "cpu")
    assert {"coal2048", "coalK", "c_r512", "c_r1024", "cK_r512"} <= \
        set(weights)
    x = torch.randn(8, 4096, generator=torch.Generator().manual_seed(5))
    plane = p1.variant_plain("plane", x, weights["plane"])
    for name, w in weights.items():
        assert torch.equal(p1.variant_plain(name, x, w), plane), name


# -- entry points -------------------------------------------------------------


@pytest.mark.parametrize("name,probe", [("kernel_decompose", p2),
                                        ("dequant_variants", p3),
                                        ("coalesced", p1)])
def test_entry_point_on_cpu(name, probe):
    r = subprocess.run(
        [sys.executable, "-m", f"llm_tpu_torch.probes.{name}", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert any(line.startswith("variant") for line in lines)
    res = json.loads(lines[-1])
    assert res["probe"] == name and res["device"] == "cpu"
    rows = res.get("variants") or res.get("modes")
    assert rows and all(v["us"] is None for v in rows.values())


@pytest.mark.parametrize("probe", [p1, p2, p3])
def test_entry_point_defaults_to_the_card(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        probe.main([])


def test_build_rebuilds_when_a_header_is_newer(tmp_path, monkeypatch):
    """A library is stale when its source or a csrc/ header it includes is
    newer (the probe and production kernels share csrc/qmatmul_tc.cuh);
    a header it does not include leaves it built."""
    import os

    from llm_tpu_torch import _build

    csrc, out = tmp_path / "csrc", tmp_path / "kernels"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    for f, t in (("k.cu", 100), ("body.cuh", 100), ("other.cuh", 100),
                 ("../kernels/libk.so", 200)):
        (csrc / f).write_text("")
        os.utime(csrc / f, (t, t))
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "body.cuh"\n')
    os.utime(csrc / "k.cu", (100, 100))
    assert not _build._stale("k")
    os.utime(csrc / "other.cuh", (300, 300))
    assert not _build._stale("k")
    os.utime(csrc / "body.cuh", (300, 300))
    assert _build._stale("k")
    (out / "libk.so").unlink()
    assert _build._stale("k")
