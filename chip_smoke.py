#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`llm_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build:   nvcc compiles csrc/qmatmul.cu and csrc/paged_attention.cu
            (which also serves the dense cache's attention) for sm_90a,
            both at once, into build/kernels/.
2. kernels: each kernel's wrapper runs on the card at the LLaMA-7B shapes
            of the main paths (qmatmul at M = 1, 8, 16, 64 and 512; dense
            attention at B = 1 and 8; paged attention at B = 4-64) and is
            held against its plain PyTorch version on the same inputs;
            times of kernel, plain version, one PyTorch library call, and
            the card's bound.
3. e2e:     a full-width random LLaMA-7B Q4_0 checkpoint (seed 0, ~3.9 GB,
            written under build/smoke/ and removed afterwards) is loaded
            on the card, and `InferenceSession.infer` answers three greedy
            prompts (16, 64 and 1100 tokens, 32 new tokens each) with the
            launch counters set to 0 just before and read just after. The
            first prefill and decode logits are then held against the
            port's plain path on the same card.
4. serve:   the same model behind the port's HTTP server: a paged engine
            (16 streams, page 256, int8 pool, prefix cache) answers 16
            concurrent greedy /v1/completions (4 of them streamed) and then
            one 512-token prompt twice (the second an exact prefix-cache
            hit); a dense engine (8 streams, bf16 cache) runs 8 requests
            directly. The launch counters are set to 0 just before each
            engine's run and read just after it: per forward the engine
            ran, qmatmul must have launched 129 times, and per decode-shaped
            (T=1) forward the engine's attention kernel 32 times (paged:
            also 32 per decode step the engine counted), the other attention
            kernel never. Then the first decode logits of 4
            streams are held against the plain path and against the dense
            engine, on the same card, and torch.profiler traces a decode
            step of each engine with every slot decoding, and a prefill
            chunk of each.

Output: one JSON line per phase, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}. `--json PATH` also writes the
full results to PATH. Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores

# LLaMA-7B (n_embd 4096, n_ff 11008, 32 heads of 128, vocab 32000)
E, FF, H, D, V, N_LAYER, CTX = 4096, 11008, 32, 128, 32000, 32, 2048
# (name, K, R) of each projection, fused as the port fuses them
SHAPES_7B = [("qkv", E, 3 * E), ("wo", E, E), ("gate_up", E, 2 * FF),
             ("down", FF, E), ("lm_head", E, V)]
PROMPT_LENS = (16, 64, 1100)
N_PREDICT = 32
N_BATCH = 512

# Tolerances (kernel vs its plain version on the same card):
# - qmatmul: the kernel rounds x and each dequantized weight to bf16
#   (relative error <= 2^-9 each) and accumulates in f32; the plain version
#   is f32. So |y - y_plain| <= 2^-8 * (|x| @ |W|) + f32 summation error;
#   held to 2^-7 * (|x| @ |W|). Against the same math with x and W rounded
#   to bf16 (`bf16_plain`) only the f32 summation order differs: held to
#   1e-5 * max(|x| @ |W|).
# - dense_attention, paged_attention: f32 throughout on both sides, split
#   into other blocks: m, l and acc within 1e-5 relative (of max|acc| for
#   acc); a stream with n_past = 0 gives exactly m = -1e30, l = 0, acc = 0.
QM_TOL_PLAIN = 2.0**-7
QM_TOL_BF16 = 1e-5
ATTN_TOL = 1e-5
SERVE8_N_PAST = (0, 17, 100, 199, 256, 301, 333, 512)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing


class Timer:
    """Median device time of a call, with the 50 MB L2 flushed before each
    run (the main path streams each weight once per step, cold).

    The flush reads 256 MB: a write would leave the L2 full of dirty lines
    whose write-back the timed call would pay for. A spin kernel of ~1 ms
    then runs before the start event, so the host has enqueued the whole
    call before the card reaches it: the time is the card's, not the
    wrapper's Python."""

    SPIN_CYCLES = 2_000_000  # ~1.1 ms at the H100's 1.75 GHz boost clock

    def __init__(self, dev):
        self.flush = torch.ones(64 << 20, dtype=torch.int32, device=dev)

    def ms(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def plane_bytes(w) -> int:
    return sum(p.numel() * p.element_size() for p in w.planes()
               if p is not None)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def random_weight(t, K: int, R: int, rng, dev):
    """A packed random weight. Small ones are also packed on the CPU, and
    the card's planes must equal those bit for bit (the loader packs on the
    card; the CPU tests hold the CPU planes equal to llm_tpu's)."""
    from llm_tpu_torch.ggml.quant import quantize
    from llm_tpu_torch.ops.packing import pack_ggml
    from llm_tpu_torch.testing import _random_kquant, _random_scalar_quant

    n = K * R
    if t.name.endswith("_K"):
        raw = _random_kquant(rng, t, n)
    elif n > 1 << 22:  # GB-scale writer of the bench checkpoints
        raw = _random_scalar_quant(rng, t, n)
    else:
        raw = quantize(t, (rng.standard_normal(n) * 0.1).astype(np.float32))
    w = pack_ggml(t, raw, (K, R), device=dev)
    if n <= 1 << 22:
        ref = pack_ggml(t, raw, (K, R), device="cpu")
        for a, b in zip(w.planes(), ref.planes()):
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a.cpu(), b)):
                fail(f"{t.name}: planes packed on the card differ from the "
                     "CPU's")
    return w


def check_qmatmul(name, w, M, rng, dev, timer, timed: bool) -> dict:
    from llm_tpu_torch.ops import packing
    from llm_tpu_torch.ops import qmatmul as qm

    x = torch.from_numpy(rng.standard_normal((M, w.k)).astype(np.float32)
                         ).to(dev)
    y = qm.qmatmul(x, w)
    torch.cuda.synchronize()
    wd = packing.dequant(w)
    y_plain = qm.qmatmul_plain(x, w)
    y_bf16 = x.bfloat16().float() @ wd.bfloat16().float()
    bound = x.abs() @ wd.abs()
    err = (y - y_plain).abs()
    err_bf16 = (y - y_bf16).abs()
    ok = bool((err <= QM_TOL_PLAIN * bound).all()) and bool(
        err_bf16.max() <= QM_TOL_BF16 * bound.max())
    rec = {
        "case": name, "fmt": w.fmt_name, "scale_packed": w.scale_packed,
        "M": M, "K": w.k, "R": w.r, "ok": ok,
        "max_abs_err": float(err.max()),
        "max_abs_err_bf16_plain": float(err_bf16.max()),
        "max_abs_y": float(y_plain.abs().max()),
    }
    if timed:
        w_bf16 = wd.bfloat16()
        xb = x.bfloat16()
        rec["ms"] = timer.ms(lambda: qm.qmatmul(x, w))
        rec["plain_ms"] = timer.ms(lambda: qm.qmatmul_plain(x, w))
        rec["library_ms"] = timer.ms(lambda: torch.matmul(xb, w_bf16))
        n_bytes = M * w.k * 4 + plane_bytes(w) + M * w.r * 4
        rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes,
                                                   2.0 * M * w.k * w.r)
    del wd, bound
    return rec


def qmatmul_phase(dev, timer) -> list[dict]:
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops import packing

    rng = np.random.default_rng(1)
    recs = []
    # every format the kernel instantiates, at a small shape
    for t in packing.FORMATS:
        w = random_weight(t, 512, 256, rng, dev)
        recs.append(check_qmatmul("small", w, 4, rng, dev, timer, False))
        if w.scale_packed:  # the f32-scale instantiation of the format
            wf = packing.QuantTensor(
                w.fmt_name, w.k, w.r, w.lo, w.hi,
                packing.expand_f16x2(w.scale).contiguous(),
                None if w.bias is None
                else packing.expand_f16x2(w.bias).contiguous())
            recs.append(check_qmatmul("small", wf, 4, rng, dev, timer,
                                      False))
    # the main path's shapes at 7B
    for name, K, R in SHAPES_7B:
        w = random_weight(GgmlType.Q4_0, K, R, rng, dev)
        # infer's decode and prefill; the serving decode (8 and 16 streams)
        # and its prefill chunks
        for M in (1, 8, 16, 64, N_BATCH):
            recs.append(check_qmatmul(name, w, M, rng, dev, timer, True))
        del w
    return recs


def check_attention(name, kv, W, n_past, hkv, rep, alibi, rng, dev, timer,
                    timed) -> dict:
    """The dense pass over a [2, B, hkv, 2048, D] cache, one stream per
    entry of `n_past`."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops.layers import alibi_slopes

    L, B, S = 2, len(n_past), CTX
    shape = (L, B, hkv, S, D)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    if kv == "int8":
        ck = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        cv = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=g, device=dev) * 0.02
        vs = torch.rand(shape[:-1], generator=g, device=dev) * 0.02
    else:
        ck = torch.randn(shape, generator=g, device=dev).bfloat16()
        cv = torch.randn(shape, generator=g, device=dev).bfloat16()
        ks = vs = None
    qf = torch.randn((B, 1, hkv, rep, D), generator=g, device=dev)
    npast = torch.tensor(n_past, dtype=torch.int32, device=dev)
    slopes = (alibi_slopes(hkv * rep, 8.0, dev).reshape(hkv, rep)
              if alibi else None)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(D))
    layer = 1
    args = (spec, ck, cv, ks, vs, npast, W, layer, qf, slopes)
    got = da.dense_attention_pass(*args)
    torch.cuda.synchronize()
    ref = da.dense_attention_plain(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scales = [float(b.abs().max()) for b in ref]
    ok = (errs[0] <= ATTN_TOL * max(1.0, abs(scales[0]))
          and errs[1] <= ATTN_TOL * max(1.0, scales[1])
          and errs[2] <= ATTN_TOL * max(1.0, scales[2]))
    empty = npast == 0  # the constants the caller's merge relies on
    ok = ok and bool((got[0][empty] == da.NEG_INF).all()) and bool(
        (got[1][empty] == 0).all()) and bool((got[2][empty] == 0).all())
    rec = {"case": name, "kv": kv, "W": W, "B": B, "n_past": list(n_past),
           "Hkv": hkv, "rep": rep, "alibi": alibi, "ok": bool(ok),
           "max_abs_err": max(errs), "errs_m_l_acc": errs}
    if timed:
        rec["ms"] = timer.ms(lambda: da.dense_attention_pass(*args))
        rec["plain_ms"] = timer.ms(lambda: da.dense_attention_plain(*args))
        rec["library_ms"] = None
        if kv == "bf16" and rep == 1 and not alibi:
            # one PyTorch call over the same window: attention output
            # (acc / l) of the cached keys below n_past
            k_w, v_w = ck[layer, :, :, :W], cv[layer, :, :, :W]
            q_b = qf[:, 0].bfloat16()  # [B, Hkv, 1, D]
            mask = (torch.arange(W, device=dev)[None] < npast[:, None]
                    )[:, None, None]  # [B, 1, 1, W]
            rec["library_ms"] = timer.ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q_b, k_w, v_w, attn_mask=mask, scale=spec.kq_scale))
        # bytes: each K and V row below n_past read once (+ its scales), q
        # read, partials written; operations: q.k and p.v, 4 D a key and
        # query head
        keys = int(npast.clamp(max=W).sum())
        item = ck.element_size()
        n_bytes = (2 * hkv * keys * D * item
                   + (2 * hkv * keys * 4 if kv == "int8" else 0)
                   + qf.numel() * 4 + B * hkv * rep * (D + 2) * 4)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n_bytes, 4.0 * hkv * rep * keys * D)
    return rec


def attention_phase(dev, timer) -> list[dict]:
    rng = np.random.default_rng(2)
    recs = []
    for kv in ("bf16", "int8"):
        for W in (512, 2048):
            for n_past in (0, W // 2 + 3, W):
                recs.append(check_attention(
                    "7b", kv, W, [n_past], H, 1, False, rng, dev, timer,
                    timed=n_past == W))
    recs.append(check_attention("gqa_alibi", "bf16", 1536, [1100], 8, 4,
                                True, rng, dev, timer, timed=True))
    # the dense engine's decode step: 8 slots, one empty, window 512
    for kv in ("bf16", "int8"):
        recs.append(check_attention(
            "serve8", kv, 512, SERVE8_N_PAST, H, 1, False, rng, dev, timer,
            timed=True))
    recs.append(check_slot_view(dev))
    return recs


def check_slot_view(dev) -> dict:
    """The dense engine's prefill of one slot runs a B=1 forward over a
    view of slot 2 of a [L, 4, Hkv, S, D] cache, whose T=1 chunks read the
    view in place: it must give what the same rows give copied out, and
    agree with the plain version."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da

    g = torch.Generator(device=dev).manual_seed(6)
    shape = (2, 4, H, 512, D)
    ck = torch.randn(shape, generator=g, device=dev).bfloat16()
    cv = torch.randn(shape, generator=g, device=dev).bfloat16()
    qf = torch.randn((1, 1, H, 1, D), generator=g, device=dev)
    npast = torch.tensor([300], dtype=torch.int32, device=dev)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(D))
    view = (ck[:, 2:3], cv[:, 2:3])
    copy = (view[0].contiguous(), view[1].contiguous())
    got = da.dense_attention_pass(spec, *view, None, None, npast, 512, 1, qf)
    same = da.dense_attention_pass(spec, *copy, None, None, npast, 512, 1, qf)
    ref = da.dense_attention_plain(spec, *view, None, None, npast, 512, 1, qf)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    ok = all(torch.equal(a, b) for a, b in zip(got, same)) and all(
        e <= ATTN_TOL * max(1.0, float(b.abs().max()))
        for e, b in zip(errs, ref))
    return {"case": "slot_view", "kv": "bf16", "W": 512, "n_past": 300,
            "ok": bool(ok), "max_abs_err": max(errs), "errs_m_l_acc": errs}


# (name, pool, page, B, n_past of the streams, Hkv, rep, ALiBi): shuffled
# page tables, trash entries past each stream's pages, stream 0 empty
PAGED_CASES = [
    ("serve16", "bf16", 16, 16, ("upto", 2000), H, 1, False),
    ("serve64", "bf16", 256, 64, ("at", 200), H, 1, False),
    ("serve64", "int8", 256, 64, ("at", 200), H, 1, False),
    ("serve64", "int4", 256, 64, ("at", 200), H, 1, False),
    ("f32", "f32", 16, 4, ("upto", 520), H, 1, False),
    # 64 query heads over 8 kv heads (LLaMA-70B's grouping), and rep 4
    ("gqa_alibi", "bf16", 128, 16, ("upto", 1100), 8, 8, True),
    ("gqa_alibi", "bf16", 128, 16, ("upto", 1100), 8, 4, True),
]
PAGED_LAYER = 5


def paged_inputs(kv, page, B, n_past_spec, hkv, rep, alibi, rng, dev):
    """A 32-layer pool holding each stream's pages at shuffled physical
    ids, its tables (trash page 0 past each stream's pages, plus two spare
    columns), n_past, q and the ALiBi slopes."""
    from llm_tpu_torch.ops.layers import alibi_slopes

    kind, top = n_past_spec
    if kind == "at":  # the reference bench's geometry, one stream mid-page
        n_past = np.full(B, top)
        n_past[1] = top // 2 + 1
    else:
        n_past = rng.integers(1, top + 1, B)
        n_past[1] = top
    n_past[0] = 0
    pages = [-(-int(n) // page) for n in n_past]
    wp = max(pages)
    NP = 1 + sum(pages)
    perm = rng.permutation(np.arange(1, NP))
    tables = np.zeros((B, wp + 2), np.int32)
    at = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[at : at + n]
        at += n
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    shape = (N_LAYER, NP, hkv, page, D)
    ks = vs = None
    if kv in ("int8", "int4"):
        lo, hi, dt = (-127, 128, torch.int8) if kv == "int8" else \
            (0, 256, torch.uint8)
        cshape = shape if kv == "int8" else shape[:-1] + (D // 2,)
        pk = torch.randint(lo, hi, cshape, generator=g, device=dev, dtype=dt)
        pv = torch.randint(lo, hi, cshape, generator=g, device=dev, dtype=dt)
        ks = torch.rand(shape[:-1], generator=g, device=dev) * 0.02
        vs = torch.rand(shape[:-1], generator=g, device=dev) * 0.02
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        pk = torch.randn(shape, generator=g, device=dev).to(dt)
        pv = torch.randn(shape, generator=g, device=dev).to(dt)
    qf = torch.randn((B, 1, hkv, rep, D), generator=g, device=dev)
    slopes = (alibi_slopes(hkv * rep, 8.0, dev).reshape(hkv, rep)
              if alibi else None)
    return (pk, pv, ks, vs, torch.from_numpy(tables).to(dev),
            torch.from_numpy(n_past.astype(np.int32)).to(dev), slopes, wp,
            qf)


def check_paged(case, rng, dev, timer) -> dict:
    from types import SimpleNamespace

    from llm_tpu_torch.ops import paged_attention as pa

    name, kv, page, B, n_past_spec, hkv, rep, alibi = case
    pk, pv, ks, vs, tables, npast, slopes, wp, qf = paged_inputs(
        kv, page, B, n_past_spec, hkv, rep, alibi, rng, dev)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(D))
    args = (spec, pk, pv, ks, vs, tables, npast, slopes, wp, PAGED_LAYER, qf)
    got = pa.paged_attention_pass(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scales = [float(b.abs().max()) for b in ref]
    ok = all(e <= ATTN_TOL * max(1.0, s) for e, s in zip(errs, scales))
    empty = npast == 0  # the constants the caller's merge relies on
    ok = ok and bool((got[0][empty] == pa.NEG_INF).all()) and bool(
        (got[1][empty] == 0).all()) and bool((got[2][empty] == 0).all())
    rec = {"case": name, "kv": kv, "page": page, "B": B, "Hkv": hkv,
           "rep": rep, "alibi": alibi, "window_pages": wp,
           "n_past_max": int(npast.max()), "n_past_sum": int(npast.sum()),
           "ok": bool(ok), "max_abs_err": max(errs), "errs_m_l_acc": errs}
    rec["ms"] = timer.ms(lambda: pa.paged_attention_pass(*args))
    rec["plain_ms"] = timer.ms(lambda: pa.paged_attention_plain(*args))
    rec["library_ms"] = None
    W = wp * page
    if kv == "bf16":
        # one PyTorch call over the same window, gathered contiguous
        # beforehand (the gather is not timed): attention output (acc / l)
        # of the keys below n_past
        cols = tables[:, :wp].long()
        k_w = pk[PAGED_LAYER][cols].transpose(1, 2).reshape(B, hkv, W, D)
        v_w = pv[PAGED_LAYER][cols].transpose(1, 2).reshape(B, hkv, W, D)
        q_b = qf[:, 0].bfloat16()  # [B, Hkv, rep, D]
        pos = torch.arange(W, device=dev)
        valid = (pos[None] < npast[:, None])[:, None, None]  # [B,1,1,W]
        mask = valid
        if alibi:
            mask = torch.where(valid, (slopes[:, :, None] * pos)[None],
                               float("-inf")).bfloat16()
        rec["library_ms"] = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q_b, k_w, v_w, attn_mask=mask, scale=spec.kq_scale))
        del k_w, v_w
    # bytes: each K and V row below n_past read once (+ its scales), q
    # read, partials written; operations: q.k and p.v in f32, 4 D a key
    # and query head
    row = D // 2 if kv == "int4" else D * pk.element_size()
    per_key = hkv * (2 * row + (8 if ks is not None else 0))
    io = qf.numel() * 4 + B * hkv * rep * (D + 2) * 4
    keys = int(npast.clamp(max=W).sum())
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        keys * per_key + io, 4.0 * D * rep * hkv * keys, F32_FLOPS)
    del pk, pv, ks, vs
    return rec


def paged_phase(dev, timer) -> list[dict]:
    rng = np.random.default_rng(5)
    recs = [check_paged(c, rng, dev, timer) for c in PAGED_CASES]
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 3: the main path end to end


@contextlib.contextmanager
def plain_versions():
    """Route every wrapper's CUDA calls to its plain version (the
    reference run of this script only; the port itself never does this)."""
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
    from llm_tpu_torch.ops import qmatmul as qm

    saved = qm.qmatmul_cuda, da.dense_attention_cuda, pa.paged_attention_cuda
    qm.qmatmul_cuda = qm.qmatmul_plain
    da.dense_attention_cuda = da.dense_attention_plain
    pa.paged_attention_cuda = pa.paged_attention_plain
    try:
        yield
    finally:
        (qm.qmatmul_cuda, da.dense_attention_cuda,
         pa.paged_attention_cuda) = saved


def count_online_prefills():
    """Count the online-softmax prefill passes (forward's own branch)."""
    from llm_tpu_torch.models import forward as fwd

    inner = fwd.online_cache_pass_batched
    calls = [0]

    def wrapped(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    fwd.online_cache_pass_batched = wrapped
    return calls


def greedy_prompt_run(model, prompt: list[int]) -> dict:
    from llm_tpu_torch import session as S
    from llm_tpu_torch.samplers import build_sampler_chain

    sess = S.InferenceSession(model, S.InferenceSessionConfig(
        memory_k_type=S.ModelKVMemoryType.Float16,
        memory_v_type=S.ModelKVMemoryType.Float16, n_batch=N_BATCH))
    chain = build_sampler_chain(["topk:k=1"],
                                bias=[(model.eot_token_id(), float("-inf"))])
    stats = sess.infer(
        S.InferenceRequest(prompt=prompt, maximum_token_count=N_PREDICT,
                           parameters=S.InferenceParameters(sampler=chain)),
        rng=np.random.default_rng(0))
    new = sess.tokens[len(prompt):]
    if len(new) != N_PREDICT or stats.prompt_tokens != len(prompt):
        fail(f"prompt of {len(prompt)}: {len(new)} new tokens")
    if not np.isfinite(sess.last_logits).all():
        fail("non-finite logits")
    decode_s = stats.predict_duration - stats.feed_prompt_duration
    return {
        "prompt_tokens": len(prompt), "new_tokens": len(new),
        "prefill_s": stats.feed_prompt_duration,
        "prefill_tok_s": len(prompt) / stats.feed_prompt_duration,
        "decode_tok_s": len(new) / decode_s,
        "decode_ms_per_token": 1e3 * decode_s / len(new),
        "first_new_ids": new[:8],
    }


def first_logits(model, ids: list[int]):
    """Logits of one prefill chunk and of the decode step after it."""
    from llm_tpu_torch.models.forward import (
        forward_step,
        init_cache,
        window_bucket,
    )

    spec = model.spec
    cache = init_cache(spec, torch.bfloat16, model.device)
    pre, _, cache = forward_step(spec, model.params, torch.tensor(ids), 0,
                                 cache, window_bucket(0, spec.n_ctx))
    nxt = int(pre[-1].argmax())
    dec, _, _ = forward_step(spec, model.params, torch.tensor([nxt]),
                             len(ids), cache,
                             window_bucket(len(ids), spec.n_ctx))
    return pre.float(), dec.float()


def decode_profile(model, prompt: list[int], steps: int = 4) -> dict:
    """Where one decode token's time goes (`infer`'s B=1 step after a
    prompt): see `step_profile`."""
    from llm_tpu_torch.models.forward import (
        forward_step,
        init_cache,
        window_bucket,
    )

    spec = model.spec
    cache = init_cache(spec, torch.bfloat16, model.device)
    state = {"n": 0, "ids": prompt}

    def step():
        n = state["n"]
        logits, _, _ = forward_step(spec, model.params,
                                    torch.tensor(state["ids"]), n, cache,
                                    window_bucket(n, spec.n_ctx))
        state["n"] = n + len(state["ids"])
        state["ids"] = [int(logits[-1].argmax())]  # syncs, as sampling does

    step()  # prefill
    out = step_profile(step, steps)
    out["window"] = window_bucket(state["n"], spec.n_ctx)
    return out


def step_profile(step, steps: int = 4) -> dict:
    """Host wall ms per call of `step` (which must end by reading a result
    back, as sampling does), and the device kernels torch.profiler sees
    over `steps` more calls: their time, launches and the card's busy
    share of the untraced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    t0 = time.monotonic()
    for _ in range(steps):
        step()
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            step()
        traced_ms = 1e3 * (time.monotonic() - t0) / steps
    # device kernels only: key_averages() also lists the CPU ops that
    # launched them, with the same device time, which would count it twice
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")  # union of the kernels' intervals
    by_name: dict[str, list[float]] = {}
    for start, end, name in kernels:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        agg = by_name.setdefault(name, [0.0, 0])
        agg[0] += end - start
        agg[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms_per_step": wall_ms,
        "traced_wall_ms_per_step": traced_ms,
        "device_ms_per_step": (sum(t for t, _ in by_name.values()) / 1e3
                               / steps) if kernels else None,
        # the card's busy time over the untraced step: the profiler slows
        # the host, not the kernels
        "device_busy_share": (busy_us / 1e3 / steps / wall_ms
                              if kernels else None),  # None: none traced
        "device_launches_per_step": len(kernels) / steps,
        "top_device": [{"kernel": k[:80], "ms_per_step": t / 1e3 / steps,
                        "launches_per_step": c / steps}
                       for k, (t, c) in top[:8]],
    }


def e2e_phase(dev):
    from llm_tpu_torch import loader
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.testing import make_bench_file

    out = {}
    smoke_dir = ROOT / "build" / "smoke"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    path = smoke_dir / "llama7b-q4_0.bin"
    try:
        t0 = time.monotonic()
        make_bench_file("llama", path, GgmlType.Q4_0, seed=0, n_ff=FF,
                        n_vocab=V, n_embd=E, n_head=H, n_layer=N_LAYER,
                        n_mult=256)
        out["write_s"] = time.monotonic() - t0
        out["file_bytes"] = path.stat().st_size

        t0 = time.monotonic()
        model = loader.load(path, "llama",
                            params=loader.ModelParameters(context_size=CTX),
                            device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t0
    finally:
        path.unlink(missing_ok=True)
    spec = model.spec
    if (spec.n_embd, spec.n_head, spec.n_layer, spec.n_vocab) != \
            (E, H, N_LAYER, V):
        fail(f"loaded spec {spec}")
    out["weights_bytes"] = torch.cuda.memory_allocated(dev)

    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, V, n).tolist() for n in PROMPT_LENS]
    online = count_online_prefills()
    # warm-up: first launches load the libraries and the allocator
    greedy_prompt_run(model, prompts[0][:4])

    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    online[0] = 0
    runs = [greedy_prompt_run(model, p) for p in prompts]
    launches = read_launches()
    out["online_prefill_passes"] = online[0]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["runs"] = runs
    out["launches"] = launches

    # a step is a prefill chunk or a decode token; a 1-token chunk is
    # decode-shaped and reads the cache through the attention kernel too
    steps = sum(math.ceil(n / N_BATCH) + N_PREDICT for n in PROMPT_LENS)
    decode_steps = sum(N_PREDICT + (n % N_BATCH == 1) for n in PROMPT_LENS)
    want = {"qmatmul": (4 * N_LAYER + 1) * steps,
            "dense_attention": N_LAYER * decode_steps, "paged_attention": 0}
    out["launches_expected"] = want
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")
    # the 1100-token prompt's third chunk reads a 1024 window: online branch
    if online[0] != N_LAYER:
        fail(f"online prefill passes {online[0]}, expected {N_LAYER}")

    out["decode_profile"] = decode_profile(model, prompts[1])

    # first prefill and decode logits against the plain path, same card
    ids = prompts[1]
    pre_k, dec_k = first_logits(model, ids)
    with plain_versions():
        pre_p, dec_p = first_logits(model, ids)
    out["prefill_logits"] = compare_logits("prefill", pre_k, pre_p)
    out["decode_logits"] = compare_logits("decode", dec_k, dec_p)
    return out, model


def compare_logits(name, got, ref) -> dict:
    """Relative L2 and top-1 agreement of two logits tensors [.., V]; fails
    the run past E2E_REL_L2."""
    if got.shape != ref.shape or got.shape[-1] != V or \
            not bool(torch.isfinite(got).all()):
        fail(f"{name} logits {tuple(got.shape)} or non-finite")
    rel_l2 = float((got - ref).norm() / ref.norm())
    rec = {"max_abs_err": float((got - ref).abs().max()), "rel_l2": rel_l2,
           "max_abs": float(ref.abs().max()),
           "top1_agree": float((got.argmax(-1) == ref.argmax(-1))
                               .float().mean())}
    if rel_l2 > E2E_REL_L2:
        fail(f"{name} logits differ: rel L2 {rel_l2:.3g} > {E2E_REL_L2}")
    return rec


# Kernel path vs plain path, full model: each of the 129 matmuls of a step
# rounds x and W to bf16 (relative error ~2^-8 per product, random in
# sign), and the errors travel down the 32-layer residual stream. Held to
# a relative L2 error of the logits of 2^-8: the whole model may drift no
# further than one product's rounding.
E2E_REL_L2 = 2.0**-8


# ---------------------------------------------------------------------------
# phase 4: serving end to end


SERVE_STREAMS, SERVE_PAGE, SERVE_NEW = 16, 256, 32
DENSE_STREAMS = 8
PREFIX_LEN = 512  # two full pages: the repeat is an exact prefix-cache hit


def record_steps(engine) -> list:
    """Log (decoding streams, [seconds of each prefill chunk], seconds) of
    every engine step. A chunk and a step each end by copying logits to
    the host, so their wall times include the card's work."""
    log = []
    step, chunk, decodable = (engine.step, engine._prefill_chunk,
                              engine._decodable)
    state = {"chunks": [], "decoding": 0}

    def timed_chunk(stream, slot):
        t0 = time.monotonic()
        out = chunk(stream, slot)
        state["chunks"].append(time.monotonic() - t0)
        return out

    def counted_decodable():
        out = decodable()
        state["decoding"] = len(out)
        return out

    def timed_step():
        state["chunks"], state["decoding"] = [], 0
        t0 = time.monotonic()
        events = step()
        log.append((state["decoding"], state["chunks"],
                    time.monotonic() - t0))
        return events

    engine.step = timed_step
    engine._prefill_chunk = timed_chunk
    engine._decodable = counted_decodable
    return log


def step_summary(log, streams: int) -> dict:
    """Where a run's engine steps spent their wall time: prefill chunks
    (each a B=1 forward), the rest of each step (the batched decode
    forward and host sampling), and the median step that decoded
    `streams` streams and ran no chunk (None when there was none)."""
    chunks = [c for _, cs, _ in log for c in cs]
    decode = [dt for n, cs, dt in log if n == streams and not cs]
    return {
        "steps": len(log),
        "prefill_chunks": len(chunks),
        "prefill_chunk_ms_median": (1e3 * float(np.median(chunks))
                                    if chunks else None),
        "prefill_s": sum(chunks),
        "other_s": sum(dt for _, _, dt in log) - sum(chunks),
        f"decode_step_ms_{streams}": (1e3 * float(np.median(decode))
                                      if decode else None),
    }


@contextlib.contextmanager
def counted_forwards(module, name: str):
    """Count the forwards an engine runs through `module.<name>` (ids
    [B, T]): all of them, and the decode-shaped ones (T = 1)."""
    inner = getattr(module, name)
    counts = {"forwards": 0, "t1_forwards": 0}

    def wrapped(spec, params, ids, *a, **k):
        counts["forwards"] += 1
        counts["t1_forwards"] += ids.shape[-1] == 1
        return inner(spec, params, ids, *a, **k)

    setattr(module, name, wrapped)
    try:
        yield counts
    finally:
        setattr(module, name, inner)


def zero_launches() -> None:
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
    from llm_tpu_torch.ops import qmatmul as qm

    qm.LAUNCHES = da.LAUNCHES = pa.LAUNCHES = 0


def read_launches() -> dict:
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
    from llm_tpu_torch.ops import qmatmul as qm

    return {"qmatmul": qm.LAUNCHES, "dense_attention": da.LAUNCHES,
            "paged_attention": pa.LAUNCHES}


def check_engine_launches(name, launches, counts, attention) -> dict:
    """Exact launch counts of one engine run: 129 qmatmul launches (4
    projections x 32 layers + lm_head) per forward, 32 launches of the
    engine's `attention` kernel per decode-shaped forward (the T=1 ones;
    longer prefill chunks take its plain page pass or the torch prefill
    attention), and none of the other attention kernel."""
    want = {"qmatmul": (4 * N_LAYER + 1) * counts["forwards"],
            "dense_attention": 0, "paged_attention": 0}
    want[attention] = N_LAYER * counts["t1_forwards"]
    if launches != want or not counts["t1_forwards"]:
        fail(f"{name}: kernel launches {launches}, expected {want} for "
             f"{counts}")
    return want


def http_completion(url: str, body: dict) -> dict:
    """POST one completion; for a streamed one, also the client's time to
    its first text fragment."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    out = {"ttft_client_s": None}
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not body.get("stream"):
            choice = json.loads(resp.read())["choices"][0]
            out.update(text=choice["text"], finish=choice["finish_reason"])
        else:
            parts, finish = [], None
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                choice = json.loads(line[6:])["choices"][0]
                if choice["finish_reason"] is not None:
                    finish = choice["finish_reason"]
                elif choice["text"]:
                    if not parts:
                        out["ttft_client_s"] = time.monotonic() - t0
                    parts.append(choice["text"])
            out.update(text="".join(parts), finish=finish)
    out["total_s"] = time.monotonic() - t0
    if out["text"].count("<t") != body["max_tokens"] or \
            out["finish"] != "length":
        fail(f"completion of {len(body['prompt'])} tokens: "
             f"{out['text'].count('<t')} tokens, finish {out['finish']}")
    return out


def first_decode_logits(engine, prompts) -> torch.Tensor:
    """Logits of each stream's first decode step (greedy, one new token)."""
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.serve import GenerationRequest

    chain = build_sampler_chain(
        ["topk:k=1"], bias=[(engine.model.eot_token_id(), float("-inf"))])
    ids = [engine.submit(GenerationRequest(prompt=p, max_tokens=1,
                                           sampler=chain)) for p in prompts]
    while engine.has_work():
        engine.step()
    return torch.from_numpy(np.stack([engine.finished[i].last_logits
                                      for i in ids]))


def engine_step_profile(engine, rng, prompt_len: int = 64) -> dict:
    """`step_profile` of an engine's batched decode step with every slot
    decoding (greedy, EoT banned; one `prompt_len`-token prompt a slot,
    each a single prefill chunk, all run by the first step)."""
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.serve import GenerationRequest

    chain = build_sampler_chain(
        ["topk:k=1"], bias=[(engine.model.eot_token_id(), float("-inf"))])
    for _ in range(engine.max_streams):
        engine.submit(GenerationRequest(
            prompt=rng.integers(1, V, prompt_len).tolist(),
            max_tokens=SERVE_NEW, sampler=chain))
    engine.step()
    if len(engine._decodable()) != engine.max_streams:
        fail("step profile: not every slot is decoding")
    out = step_profile(engine.step)
    out["streams"] = engine.max_streams
    out["n_past_max"] = max(s.n_past for s in engine.slots)
    return out


def chunk_profile(engine, rng, prompt_len: int = 640) -> dict:
    """`step_profile` of one stream's prefill, alone in the engine: every
    profiled step runs one `n_batch`-token chunk (a B=1 forward that reads
    the chunks before it) and no decode."""
    from llm_tpu_torch.serve import GenerationRequest

    engine.submit(GenerationRequest(
        prompt=rng.integers(1, V, prompt_len).tolist(), max_tokens=1))
    out = step_profile(engine.step)
    stream = engine.slots[0]
    if stream is None or not stream.prefilling:
        fail("chunk profile: the prompt finished its prefill early")
    out["prefill_pos"] = stream.prefill_pos
    return out


def http_traffic(srv, log, rng, greedy) -> dict:
    """The paged server's traffic: 16 concurrent completions of 16-700
    token prompts (4 of them streamed), then one page-aligned prompt twice,
    the second an exact prefix-cache hit. `log` is the engine's
    `record_steps` log."""
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    url = "http://%s:%d/v1/completions" % srv.address
    lens = rng.integers(16, 701, SERVE_STREAMS)
    bodies = [dict(greedy, prompt=rng.integers(1, V, n).tolist(),
                   stream=i < 4) for i, n in enumerate(lens)]
    t0 = time.monotonic()
    with ThreadPoolExecutor(SERVE_STREAMS) as pool:
        results = list(pool.map(lambda b: http_completion(url, b), bodies))
    wall = time.monotonic() - t0
    ttft = np.array(srv.loop._ttft_ms)
    out["concurrent"] = {
        "requests": len(bodies), "prompt_tokens": [int(n) for n in lens],
        "wall_s": wall,
        "generated_tok_s": SERVE_STREAMS * SERVE_NEW / wall,
        "ttft_ms_median": float(np.median(ttft)),
        "ttft_ms_max": float(ttft.max()),
        "ttft_client_s_streamed": [r["ttft_client_s"] for r in results
                                   if r["ttft_client_s"] is not None],
        **step_summary(log, SERVE_STREAMS),
    }

    # the same page-aligned prompt twice: the second is an exact hit
    prompt = rng.integers(1, V, PREFIX_LEN).tolist()
    prefix = []
    for _ in range(2):
        chunks0 = sum(len(cs) for _, cs, _ in log)
        srv.loop._ttft_ms.clear()
        r = http_completion(url, dict(greedy, prompt=prompt, stream=True))
        prefix.append({"ttft_ms": srv.loop._ttft_ms[0],
                       "ttft_client_s": r["ttft_client_s"],
                       "prefill_chunks": sum(len(cs) for _, cs, _ in log)
                       - chunks0})
    out["prefix"] = prefix
    if prefix[1]["prefill_chunks"] != 0:
        fail(f"the repeated prompt ran {prefix[1]['prefill_chunks']} "
             "prefill chunks: not an exact prefix-cache hit")
    return out


def serve_phase(model, dev) -> dict:
    from llm_tpu_torch import paged as paged_mod
    from llm_tpu_torch import serve as serve_mod
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.serve import Engine, GenerationRequest
    from llm_tpu_torch.server import LlmServer

    out = {}
    rng = np.random.default_rng(4)
    eot = model.eot_token_id()
    greedy = {"max_tokens": SERVE_NEW, "temperature": 0,
              "logit_bias": {str(eot): -100}}  # EoT banned: 32 tokens each

    # (a) the paged engine behind the HTTP server
    torch.cuda.reset_peak_memory_stats(dev)
    engine = PagedEngine(model, max_streams=SERVE_STREAMS,
                         page_size=SERVE_PAGE, kv_dtype="int8", n_batch=64,
                         prefix_cache=True)
    out["pool_bytes"] = engine.pool.nbytes()
    srv = LlmServer(model, engine, host="127.0.0.1", port=0)
    with counted_forwards(paged_mod, "paged_forward_batched") as counts:
        srv.start()
        try:
            srv.warmup()  # loads the libraries; clears the server's metrics
            log = record_steps(engine)
            zero_launches()
            counts.update(forwards=0, t1_forwards=0)  # not the warm-up's
            dispatches0 = engine.decode_dispatches
            out.update(http_traffic(srv, log, rng, greedy))
        finally:
            srv.shutdown()  # the engine thread has stopped when it returns
    launches = read_launches()
    paged_dispatches = engine.decode_dispatches - dispatches0
    out["paged_launches"] = launches
    out["paged_forwards"] = dict(counts, decode_dispatches=paged_dispatches)
    check_engine_launches("paged engine", launches, counts,
                          "paged_attention")
    if launches["paged_attention"] != N_LAYER * paged_dispatches:
        fail(f"paged_attention launched {launches['paged_attention']} "
             f"times for {paged_dispatches} paged decode steps")
    torch.cuda.synchronize()
    out["paged_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # the step log's wrappers hold the engine in a reference cycle
    del srv, engine, log
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the dense engine, driven directly
    torch.cuda.reset_peak_memory_stats(dev)
    engine = Engine(model, max_streams=DENSE_STREAMS,
                    kv_dtype=torch.bfloat16, n_batch=64)
    out["dense_cache_bytes"] = sum(t.numel() * t.element_size()
                                   for t in (engine.cache.k, engine.cache.v))
    log = record_steps(engine)
    chain = build_sampler_chain(["topk:k=1"], bias=[(eot, float("-inf"))])
    lens = rng.integers(16, 301, DENSE_STREAMS)
    reqs = [GenerationRequest(prompt=rng.integers(1, V, n).tolist(),
                              max_tokens=SERVE_NEW, sampler=chain)
            for n in lens]
    with counted_forwards(serve_mod, "forward_batched") as counts:
        zero_launches()
        t0 = time.monotonic()
        texts = engine.generate_all(reqs)
        wall = time.monotonic() - t0
        launches = read_launches()
    out["dense_launches"] = launches
    out["dense_forwards"] = counts
    check_engine_launches("dense engine", launches, counts,
                          "dense_attention")
    if any(t.count("<t") != SERVE_NEW for t in texts.values()):
        fail("dense engine: a request did not yield 32 tokens")
    out["dense"] = {"requests": len(reqs),
                    "prompt_tokens": [int(n) for n in lens], "wall_s": wall,
                    "generated_tok_s": DENSE_STREAMS * SERVE_NEW / wall,
                    **step_summary(log, DENSE_STREAMS)}
    torch.cuda.synchronize()
    out["dense"]["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del engine, log
    gc.collect()

    # (c) first decode logits of 4 streams: paged kernel path against the
    # plain path, and against the dense engine (both bf16 caches)
    prompts = [rng.integers(1, V, n).tolist() for n in (40, 100, 200, 300)]

    def paged():
        return PagedEngine(model, max_streams=4, page_size=SERVE_PAGE,
                           kv_dtype=torch.bfloat16, n_batch=64)

    got = first_decode_logits(paged(), prompts)
    with plain_versions():
        plain = first_decode_logits(paged(), prompts)
    dense = first_decode_logits(
        Engine(model, max_streams=4, kv_dtype=torch.bfloat16, n_batch=64),
        prompts)
    out["paged_vs_plain_logits"] = compare_logits("paged decode", got, plain)
    out["paged_vs_dense_logits"] = compare_logits("paged vs dense", got,
                                                  dense)
    torch.cuda.empty_cache()

    # (d) where a decode step's time goes, every slot decoding
    out["paged_step_profile"] = engine_step_profile(
        PagedEngine(model, max_streams=SERVE_STREAMS, page_size=SERVE_PAGE,
                    kv_dtype="int8", n_batch=64), rng)
    torch.cuda.empty_cache()
    out["dense_step_profile"] = engine_step_profile(
        Engine(model, max_streams=DENSE_STREAMS, kv_dtype=torch.bfloat16,
               n_batch=64), rng)
    torch.cuda.empty_cache()
    # and a prefill chunk's, without the server's threads beside it
    out["paged_chunk_profile"] = chunk_profile(
        PagedEngine(model, max_streams=1, page_size=SERVE_PAGE,
                    kv_dtype="int8", n_batch=64), rng)
    out["dense_chunk_profile"] = chunk_profile(
        Engine(model, max_streams=1, kv_dtype=torch.bfloat16, n_batch=64),
        rng)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


def kernel_entries(qrecs, arecs, precs, e2e, serve) -> list[dict]:
    """One entry per kernel: times summed over the launches of one decode
    step at 7B (qmatmul: the 4 projections x 32 layers + lm_head at M=1;
    dense_attention: 32 layers at W=512, bf16 cache, full window;
    paged_attention: 32 layers over 64 streams at n_past 200, bf16 pool,
    page 256). `launches` counts the main path that runs the kernel most:
    `infer` for qmatmul and dense_attention, the paged server for
    paged_attention; `launches_by_path` has the count of each path's own
    run: `infer`, the paged server and the dense engine."""
    per_token = {"qkv": N_LAYER, "wo": N_LAYER, "gate_up": N_LAYER,
                 "down": N_LAYER, "lm_head": 1}
    dec = [r for r in qrecs if r["M"] == 1 and r["case"] in per_token]

    def total(key, recs, weight):
        vals = [r[key] for r in recs]
        if any(v is None for v in vals):
            return None
        return sum(v * weight(r) for v, r in zip(vals, recs))

    def qw(r):
        return per_token[r["case"]]

    def per_layer(r):
        return N_LAYER

    attn = [r for r in arecs if r["case"] == "7b" and r["kv"] == "bf16"
            and r["W"] == 512 and "ms" in r]
    paged = [r for r in precs if r["case"] == "serve64" and r["kv"] == "bf16"]
    entries = []
    for name, recs, all_recs, w, path, rep, extra in (
        ("qmatmul", dec, qrecs, qw, "infer", "llm_tpu/ops/qmatmul.py:560",
         {"source": "llm_tpu_torch/csrc/qmatmul.cu",
          "replaces_also": ["llm_tpu/ops/qmatmul.py:651",
                            "llm_tpu/ops/qmatmul.py:436",
                            "llm_tpu/ops/qmatmul.py:475"],
          "per": "one 7B decode token: 129 launches at M=1",
          "tolerance": "|y - plain| <= 2^-7 (|x| @ |W|)"}),
        ("dense_attention", attn, arecs, per_layer, "infer",
         "llm_tpu/ops/dense_attention.py:195",
         {"source": "llm_tpu_torch/csrc/paged_attention.cu",
          "per": "one 7B decode token: 32 launches, W=512, bf16 cache",
          "tolerance": "m, l, acc within 1e-5 relative"}),
        ("paged_attention", paged, precs, per_layer, "serve_paged",
         "llm_tpu/ops/paged_attention.py:224",
         {"source": "llm_tpu_torch/csrc/paged_attention.cu",
          "per": "one 7B decode step of 64 streams at n_past 200: 32 "
                 "launches, bf16 pool, page 256",
          "tolerance": "m, l, acc within 1e-5 relative; n_past 0 exact"}),
    ):
        by_path = {"infer": e2e["launches"][name],
                   "serve_paged": serve["paged_launches"][name],
                   "serve_dense": serve["dense_launches"][name]}
        entries.append({
            "name": name, "route": "cuda", "source": extra.pop("source"),
            "replaces": rep, "launches": by_path[path],
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in all_recs),
            "ms": total("ms", recs, w), "plain_ms": total("plain_ms", recs, w),
            "bound_ms": total("bound_ms", recs, w),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in recs)
            else "operations",
            "library_ms": total("library_ms", recs, w), **extra,
        })
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the full results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    from llm_tpu_torch import _build

    dev = torch.device("cuda", 0)
    # every plain f32 matmul here runs in full f32, stated, not defaulted
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = {"card": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda}

    built = _build.build(["qmatmul", "paged_attention"])
    emit({"build": {"nvcc_s": built}})
    results["build"] = built

    timer = Timer(dev)
    qrecs = qmatmul_phase(dev, timer)
    arecs = attention_phase(dev, timer)
    precs = paged_phase(dev, timer)
    results["kernel_cases"] = qrecs + arecs + precs
    emit({"kernel_cases": qrecs + arecs + precs})
    bad = [r for r in qrecs + arecs + precs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad[:3]}")
    del timer

    e2e, model = e2e_phase(dev)
    results["e2e"] = e2e
    emit({"e2e": e2e})

    serve = serve_phase(model, dev)
    results["serve"] = serve
    emit({"serve": serve})
    del model

    kernels = kernel_entries(qrecs, arecs, precs, e2e, serve)
    results["kernels"] = kernels
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1))
    emit({"kernels": kernels})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
