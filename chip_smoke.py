#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`llm_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build:   nvcc compiles csrc/qmatmul.cu (the tensor-core kernel of
            csrc/qmatmul_tc.cuh), csrc/paged_attention.cu (which also
            serves the dense cache's attention) and csrc/qmatmul_probe.cu
            (the scalar kernel the probes decompose) for sm_90a, all at
            once, into build/kernels/; beside them,
            `llm_tpu_torch.probes.kernel_report` compiles its own copies
            for the compiler's report (registers, shared memory, spills of
            every kernel; SASS instructions a weight of the dequant and of
            the q4_0 kernels' main loop).
2. kernels: each kernel's wrapper runs on the card at the LLaMA-7B shapes
            of the main paths (qmatmul at M = 1, 8, 16, 64 and 512; dense
            attention at B = 1 and 8; paged attention at B = 4-64) and is
            held against its plain PyTorch version on the same inputs;
            times of kernel, plain version, one PyTorch library call, and
            the card's bound. qmatmul is also held for all 10 formats (both
            scale kinds) at a small shape at M = 1, 4, 8, 16, 64 and 512.
            K3 (qmatmul over the coalesced buffer) is held bit-equal to K1
            on the same weights for all 10 formats and at the 7B
            projections, and timed at M = 1-512. The A/B: the tensor-core
            kernel against the scalar kernel it replaced, on the same 7B
            weights (planes and coalesced) at each M, in turns old, new,
            new, old. Every probe stage, mode and tiling is held against
            its plain version, at a small shape and at the 7B shape its
            probe runs it. The attention kernel is also held at small
            shapes off the 7B ones (D 64 / 80 / 256, 4 / 8 / 71 query heads
            a kv head, page 24, all four pools, ALiBi, n_past 0, mid-page
            and full), and repeated launches, and a launch after one with
            another grid, must give bit-equal results.
3. e2e:     a full-width random LLaMA-7B Q4_0 checkpoint (seed 0, ~3.9 GB,
            written under build/smoke/, removed by the gguf phase) is loaded
            on the card, and `InferenceSession.infer` answers three greedy
            prompts (16, 64 and 1100 tokens, 32 new tokens each) with the
            launch counters set to 0 just before and read just after
            (prompt chunks of 512 rows on qmatmul's wide path, decode steps
            on its swapped path). The first prefill and decode logits are
            then held against the port's plain path on the same card.
   device_sampling: the same model (no second load) through
            `InferenceSession.infer_device`, whose T=1 decode step runs as
            a captured CUDA graph replayed once a token: one captured step
            bit-equal to the eager step on the same state (logits and
            token, greedy and top-k with penalties); greedy tokens (the
            host chain's repetition slot and the EoT ban as device
            sampler) of the three e2e prompts, 32 new each in blocks of 8,
            equal to the e2e phase's host-sampled tokens; two seeded top-k
            40 / temperature 0.8 / repetition 1.3 runs equal, a mirostat-2
            run with a finite mu; every capture counted one forward's
            launches, 4 n_layer + 1 qmatmul and n_layer attention, read
            from the model's spec (LLaMA-7B: 129 and 32). Decode ms a token of the device path
            (blocks of 8 and 32) and of host-sampled `infer` in the same
            run (CUDA events), the busy share of two profiled 32-token
            blocks, launches and replays a token, capture seconds and the
            graph pool's bytes.
   coalesced: the model's layer weights coalesced on the card
            (`coalesce_layer_weights`) give the plane run's 16 greedy
            tokens, with 128 coalesced qmatmul launches a forward (counters
            zeroed just before and read just after this run).
4. serve:   the same model behind the port's HTTP server: a paged engine
            (16 streams, page 256, int8 pool, prefix cache) answers 16
            concurrent greedy /v1/completions (4 of them streamed) and then
            one 512-token prompt twice (the second an exact prefix-cache
            hit); a dense engine (8 streams, bf16 cache) runs 8 requests
            directly. The launch counters are set to 0 just before each
            engine's run and read just after it: per forward the engine
            ran, qmatmul must have launched 4 n_layer + 1 times (LLaMA-7B:
            129; on its wide path for forwards of more than 32 rows), and
            per decode-shaped (T=1) forward the engine's attention kernel
            n_layer times (32; paged: also 32 per decode step the engine
            counted), the other attention kernel never. Then the first decode logits of 4
            streams are held against the plain path and against the dense
            engine, on the same card, and torch.profiler traces a decode
            step of each engine with every slot decoding (32 attention
            kernels a step, as `infer`'s profiled decode step), and a
            prefill chunk of each.
   multi_step: the same model served with multi-step decode. The paged
            engine of the serve phase behind `LlmServer(multi_step=16)`
            answers the serve phase's 16 concurrent greedy completions
            (the same prompts; the host chain's repetition 1.3 and the EoT
            ban as device sampler): every text equals the host-stepped
            serve phase's (where a token differs, its top-2 margin must be
            within 2^-8 of the row's largest logit), no completion ends in
            an engine error, no block fell back to `step()`, the graph
            replays equal the blocks' steps, and each capture counted one
            forward's launches (129 qmatmul and 32 paged-attention). Then
            the decode loops
            are driven directly over whole blocks of 16 (CUDA events after
            capture, one block profiled): `paged_decode_loop` at 16
            streams (the serve prompts' positions) and at 64 streams (the
            reference bench's paged-serve-64: page 256, 65 pages, n_past
            200, one window page), `decode_loop_batched` at 8 streams over
            a bf16 cache; ms a step, tok/s, the step's bound, busy share,
            replays and launches a block, capture seconds and graph pool
            bytes. One captured step is held bit-equal to the eager step
            (paged int8 greedy and a per-stream sampled mix; dense bf16
            with a masked slot, whose rows must stay).
   gguf:    the e2e file converted to GGUF v3 by the cli's `gguf-convert`
            (the classic file is removed after it) and loaded on the card:
            spec, vocabulary and every weight plane equal to the GGML
            load's; greedy `infer` of the e2e 64-token prompt (32 new)
            gives the e2e tokens, the first prefill and decode logits are
            bit-equal, the launches counted exactly (129 qmatmul a
            forward, 32 dense attention a decode step). Conversion and
            both loads timed.
   perplexity: `InferenceSession.perplexity` over 4 windows of 2048
            seeded random ids: 16 sub-chunks of 512 rows, each 129
            qmatmul launches on the wide path (counted exactly) and no
            attention kernel (prefill attention is plain torch). The first
            window's summed NLL held against the same window under the
            plain versions (x and W rounded to bf16) within 2^-7; ms a
            sub-chunk (CUDA events, and at each n_past of a window),
            scored tokens/s, the sub-chunk's bound and a profiled
            sub-chunk.
   snapshot: the e2e 64-token prompt and 16 greedy tokens, the session
            written by `snapshot.write_session`, read back onto the card
            by `read_session` (the cache equal), 16 more tokens: the e2e
            phase's uninterrupted 32. Snapshot bytes, write and read s.
   verify:  the port's harness on the GGUF file as `llm-tpu-torch verify
            -m <file>.gguf -a llama` runs it (context 2048, no goldens):
            Hyperparameters, CanSend, Inference (32 new tokens in place of
            128, determinism), Tokens (determinism) and Delete (rewind and
            refeed at the card's tolerance) pass; the inputs are `<tN>`
            markers, the bench vocabulary's. The GGUF file is removed
            after it.
   archs:   the six other architectures, each written with
            `make_bench_file` at its published width (seed 0, under
            build/smoke/, removed after loading) and loaded on the card:
            MPT-7B Q4_K whole (32 layers, vocab 50,432, ALiBi, tied head,
            context 8192), GPT-2 117M Q8_0 (context 2048, capped at its
            1024 positions), StableLM-3B Q5_1 (GPT-NeoX, 32 layers), and 4
            layers of GPT-J-6B Q4_0, BLOOM-7B1 Q4_0 and Falcon-7B Q4_0.
            Each: greedy host-sampled `infer` (MPT: prompts of 64 and 1100
            tokens, 32 new; the others 64 and 16), launches counted as in
            e2e from the spec; the first prefill and decode logits against
            the plain path (relative L2 within 2^-8, top-1 equal but at a
            near-tie); `infer_device` greedy tokens equal to the host
            ones, every capture counting 4 n_layer + 1 qmatmul and n_layer
            attention launches; decode ms a token of blocks of 16 (CUDA
            events) against the weights' bytes over HBM, host ms a step,
            the busy share of a profiled block; qmatmul at M=1 on the
            model's own weights held against its plain version and timed.
            MPT also runs `paged_decode_loop` at the reference bench's
            paged cell (2 streams at n_past 7680, page 256, int8 pool),
            and a paged int8 engine (prefix cache) and a dense bf16 engine
            answer 4 greedy prompts host-stepped and in blocks of 16 (each
            engine's block texts equal its host-stepped ones; the paged
            texts equal a dense int8 engine's). Then the attention kernel
            at Falcon-7B's decode (rep 71, D 64) and at MPT's paged cell
            against its plain version, timed. The phase prints its
            `archs_summary`.
5. probes:  P2 (`llm_tpu_torch.probes.kernel_decompose`, M = 8 and 1), P3
            (`dequant_variants`, every mode) and P1 (`coalesced`, up and
            down, every variant) at their 7B geometry with few rounds, each
            with the counters zeroed before and read after its run; their
            tables are printed.

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
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
SMALL_MS = (1, 4, 8, 16, 64, 512)  # M of the small per-format checks
ATTN_TOL = 1e-5
ATTN_KERNEL = "paged_decode"  # the attention kernel's name in a profile
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
    """Bytes of a weight's planes, or of its coalesced buffer."""
    from llm_tpu_torch.ops.packing import QuantTensorC

    if isinstance(w, QuantTensorC):
        return w.buf.numel() * 4
    return sum(p.numel() * p.element_size() for p in w.planes()
               if p is not None)


def dequant_any(w):
    from llm_tpu_torch.ops import packing

    if isinstance(w, packing.QuantTensorC):
        return packing.dequant_c(w)
    return packing.dequant(w)


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


def qmatmul_held(y, x, w) -> dict:
    """The kernel's y = x @ W against the plain version (f32) and against
    the same math with x and W rounded to bf16, to QM_TOL_PLAIN and
    QM_TOL_BF16."""
    from llm_tpu_torch.ops import qmatmul as qm

    torch.cuda.synchronize()
    wd = dequant_any(w)
    y_plain = qm.qmatmul_plain(x, w)
    y_bf16 = x.bfloat16().float() @ wd.bfloat16().float()
    bound = x.abs() @ wd.abs()
    err = (y - y_plain).abs()
    err_bf16 = (y - y_bf16).abs()
    return {"ok": bool((err <= QM_TOL_PLAIN * bound).all()) and bool(
                err_bf16.max() <= QM_TOL_BF16 * bound.max()),
            "max_abs_err": float(err.max()),
            "max_abs_err_bf16_plain": float(err_bf16.max()),
            "max_abs_y": float(y_plain.abs().max())}


def check_qmatmul(name, w, M, rng, dev, timer, timed: bool) -> dict:
    from llm_tpu_torch.ops import qmatmul as qm

    x = torch.from_numpy(rng.standard_normal((M, w.k)).astype(np.float32)
                         ).to(dev)
    rec = {"case": name, "fmt": w.fmt_name, "scale_packed": w.scale_packed,
           "layout": type(w).__name__, "M": M, "K": w.k, "R": w.r,
           **qmatmul_held(qm.qmatmul(x, w), x, w)}
    if timed:
        w_bf16 = dequant_any(w).bfloat16()
        xb = x.bfloat16()
        rec["ms"] = timer.ms(lambda: qm.qmatmul(x, w))
        rec["plain_ms"] = timer.ms(lambda: qm.qmatmul_plain(x, w))
        rec["library_ms"] = timer.ms(lambda: torch.matmul(xb, w_bf16))
        n_bytes = M * w.k * 4 + plane_bytes(w) + M * w.r * 4
        rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes,
                                                   2.0 * M * w.k * w.r)
    return rec


def qmatmul_phase(dev, timer) -> list[dict]:
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops import packing

    rng = np.random.default_rng(1)
    recs = []
    # every format the kernel instantiates, at a small shape, on every
    # consumer path (M <= 8, <= 32: swapped; larger: wide)
    for t in packing.FORMATS:
        w = random_weight(t, 512, 256, rng, dev)
        variants = [w]
        if w.scale_packed:  # the f32-scale instantiation of the format
            variants.append(packing.unpack_scales_qt(w))
        for v in variants:
            for M in SMALL_MS:
                recs.append(check_qmatmul("small", v, M, rng, dev, timer,
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


def k3_bit_equal(name, planes, coal, M, rng, dev, layer=None) -> dict:
    """K3 over the coalesced buffer against K1 over the planes it was made
    from: the same products summed in the same order, so bit-equal."""
    from llm_tpu_torch.ops import qmatmul as qm

    x = torch.from_numpy(rng.standard_normal((M, planes.k))
                         .astype(np.float32)).to(dev)
    y1 = qm.qmatmul(x, planes, layer=layer)
    y3 = qm.qmatmul(x, coal, layer=layer)
    torch.cuda.synchronize()
    return {"case": name, "fmt": planes.fmt_name,
            "scale_packed": coal.scale_packed, "M": M, "K": planes.k,
            "R": planes.r, "layer": layer,
            "tiles": [coal.tile_k, coal.tile_r, coal.kp, coal.rp],
            "ok": bool(torch.equal(y1, y3)),
            "max_abs_err": float((y1 - y3).abs().max())}


def coalesced_phase(dev, timer) -> tuple[list, list]:
    """K3: bit-equal to K1 for every format at a small shape (flat at M =
    1, 4, 16 and 64, and one layer of a stack; f16-packed and f32 scales)
    and for Q4_0 at each 7B projection at M = 1, 8, 16, 64 and n_batch (the
    coalesced `infer` run's decode and its prompt chunk, padded to n_batch;
    the serving steps); then held against its plain version and timed at
    M = 1, 8, 16, 64 and n_batch, as K1 is."""
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops import packing
    from llm_tpu_torch.ops import qmatmul as qm

    rng = np.random.default_rng(7)
    eq, recs = [], []
    for t in packing.FORMATS:
        ws = [random_weight(t, 512, 256, rng, dev) for _ in range(2)]
        variants = [ws[0]]
        if ws[0].scale_packed:  # and the format's f32-scale instantiation
            variants.append(packing.unpack_scales_qt(ws[0]))
        for i, w in enumerate(variants):
            tk, tr, _ = qm.coalesce_tiles(w.fmt, w.k_padded, w.r_padded,
                                          w.scale_packed)
            c = packing.coalesce_qt(w, tk, tr)
            for M in (1, 4, 16, 64):
                eq.append(k3_bit_equal("small", w, c, M, rng, dev))
            if i == 0:
                st = packing.QuantTensor(w.fmt_name, w.k, w.r, *(
                    None if getattr(w, n) is None else
                    torch.stack([getattr(q, n) for q in ws])
                    for n in ("lo", "hi", "scale", "bias")))
                sc = packing.coalesce_qt(st, tk, tr)
                eq.append(k3_bit_equal("small_stacked", st, sc, 4, rng, dev,
                                       layer=1))
    for name, K, R in SHAPES_7B:
        w = random_weight(GgmlType.Q4_0, K, R, rng, dev)
        c = qm.coalesce_auto(w)
        if c is None:
            fail(f"{name}: the 7B weight did not coalesce")
        for M in (1, 8, 16, 64, N_BATCH):
            eq.append(k3_bit_equal(name, w, c, M, rng, dev))
        if name != "lm_head":  # the head stays planes on the main path
            for M in (1, 8, 16, 64, N_BATCH):
                recs.append(check_qmatmul(name, c, M, rng, dev, timer, True))
        del w, c
    torch.cuda.empty_cache()
    return eq, recs


AB_MS = (1, 8, 16, 64, N_BATCH)


def ab_phase(dev, timer) -> list[dict]:
    """The tensor-core kernel against the scalar kernel it replaced
    (`qmatmul_probe.prepare_full`: one thread a column, f32 FMAs), in one
    call on one card. Prepared launches (x already staged for each) at each
    7B projection and M, over Q4_0 planes (K1) and `coalesce_auto`'s buffer
    of the same weight (K3), timed in turns old, new, new, old; both held
    against the plain version."""
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops import qmatmul as qm
    from llm_tpu_torch.ops import qmatmul_probe as qp

    rng = np.random.default_rng(12)
    recs = []
    for name, K, R in SHAPES_7B:
        w = random_weight(GgmlType.Q4_0, K, R, rng, dev)
        for layout, wt in (("planes", w), ("coalesced", qm.coalesce_auto(w))):
            for M in AB_MS:
                x = torch.from_numpy(rng.standard_normal((M, K)).astype(
                    np.float32)).to(dev)
                old, new = qp.prepare_full(x, wt), qm.prepare(x, wt)
                held_old = qmatmul_held(old(), x, wt)
                held_new = qmatmul_held(new(), x, wt)
                t = [timer.ms(f) for f in (old, new, new, old)]
                recs.append({
                    "case": name, "layout": layout, "M": M, "K": K, "R": R,
                    "path": qm.plan(w, M).path, "old_ms": [t[0], t[3]],
                    "new_ms": [t[1], t[2]],
                    "speedup": (t[0] + t[3]) / (t[1] + t[2]),
                    "ok": held_old["ok"] and held_new["ok"],
                    "max_abs_err": held_new["max_abs_err"],
                    "max_abs_err_bf16_plain":
                        held_new["max_abs_err_bf16_plain"],
                    "old_max_abs_err_bf16_plain":
                        held_old["max_abs_err_bf16_plain"]})
        del w
    torch.cuda.empty_cache()
    return recs


def attn_held(got, ref, npast) -> tuple[bool, list]:
    """m, l and acc within ATTN_TOL relative (of the largest |value|, at
    least 1), and the exact constants of the streams with no past."""
    from llm_tpu_torch.ops.paged_attention import NEG_INF

    errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    ok = all(e <= ATTN_TOL * max(1.0, float(b.abs().max()))
             for e, b in zip(errs, ref))
    empty = npast == 0  # the constants the caller's merge relies on
    ok = ok and bool((got[0][empty] == NEG_INF).all()) and bool(
        (got[1][empty] == 0).all()) and bool((got[2][empty] == 0).all())
    return ok, errs


def num_sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_attention(name, kv, W, n_past, hkv, rep, alibi, rng, dev, timer,
                    timed, d=D) -> dict:
    """The dense pass over a [2, B, hkv, 2048, d] cache, one stream per
    entry of `n_past`."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops.layers import alibi_slopes

    L, B, S = 2, len(n_past), CTX
    shape = (L, B, hkv, S, d)
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
    qf = torch.randn((B, 1, hkv, rep, d), generator=g, device=dev)
    npast = torch.tensor(n_past, dtype=torch.int32, device=dev)
    slopes = (alibi_slopes(hkv * rep, 8.0, dev).reshape(hkv, rep)
              if alibi else None)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(d))
    layer = 1
    args = (spec, ck, cv, ks, vs, npast, W, layer, qf, slopes)
    got = da.dense_attention_pass(*args)
    torch.cuda.synchronize()
    ok, errs = attn_held(got, da.dense_attention_plain(*args), npast)
    rec = {"case": name, "kv": kv, "W": W, "B": B, "n_past": list(n_past),
           "Hkv": hkv, "rep": rep, "alibi": alibi, "ok": bool(ok),
           "max_abs_err": max(errs), "errs_m_l_acc": errs}
    if timed:
        rec["ms"] = timer.ms(lambda: da.dense_attention_pass(*args))
        rec["plain_ms"] = timer.ms(lambda: da.dense_attention_plain(*args))
        rec["library_ms"] = None
        if kv == "bf16":
            # one PyTorch call over the same window: attention output
            # (acc / l) of the cached keys below n_past; the rep query
            # heads of a kv head are its rows (queries) in one head
            k_w, v_w = ck[layer, :, :, :W], cv[layer, :, :, :W]
            q_b = qf[:, 0].bfloat16()  # [B, Hkv, rep, d]
            pos = torch.arange(W, device=dev)
            mask = (pos[None] < npast[:, None])[:, None, None]  # [B,1,1,W]
            if alibi:
                mask = torch.where(mask, (slopes[:, :, None] * pos)[None],
                                   float("-inf")).bfloat16()
            rec["library_ms"] = timer.ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q_b, k_w, v_w, attn_mask=mask, scale=spec.kq_scale))
        # bytes: each K and V row below n_past read once (+ its scales), q
        # read, partials written; operations: q.k and p.v, 4 D a key and
        # query head
        keys = int(npast.clamp(max=W).sum())
        item = ck.element_size()
        n_bytes = (2 * hkv * keys * d * item
                   + (2 * hkv * keys * 4 if kv == "int8" else 0)
                   + qf.numel() * 4 + B * hkv * rep * (d + 2) * 4)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n_bytes, 4.0 * hkv * rep * keys * d)
    return rec


# (name, cache, W, n_past of the streams, Hkv, rep, ALiBi, timed) of the
# dense cache's checks: B=1 at W 512 and 2048 (empty, mid-window, full),
# GQA with ALiBi, and the dense engine's decode step (8 slots, one empty)
DENSE_CASES = [
    ("7b", kv, W, (n_past,), H, 1, False, n_past == W)
    for kv in ("bf16", "int8") for W in (512, 2048)
    for n_past in (0, W // 2 + 3, W)
] + [("gqa_alibi", "bf16", 1536, (1100,), 8, 4, True, True)] + [
    ("serve8", kv, 512, SERVE8_N_PAST, H, 1, False, True)
    for kv in ("bf16", "int8")
]


def attention_phase(dev, timer) -> list[dict]:
    rng = np.random.default_rng(2)
    recs = [check_attention(name, kv, W, list(n_past), hkv, rep, alibi, rng,
                            dev, timer, timed)
            for name, kv, W, n_past, hkv, rep, alibi, timed in DENSE_CASES]
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
    held, errs = attn_held(got, ref, npast)
    ok = held and all(torch.equal(a, b) for a, b in zip(got, same))
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


def paged_inputs(kv, page, B, n_past_spec, hkv, rep, alibi, rng, dev,
                 layers=N_LAYER):
    """A pool of `layers` layers holding each stream's pages at shuffled
    physical ids, its tables (trash page 0 past each stream's pages, plus
    two spare columns), n_past, q and the ALiBi slopes."""
    kind, top = n_past_spec
    if kind == "all":  # every stream at the same n_past
        return paged_pool(kv, page, np.full(B, top), hkv, rep, alibi, rng,
                          dev, D, layers)
    if kind == "at":  # the reference bench's geometry, one stream mid-page
        n_past = np.full(B, top)
        n_past[1] = top // 2 + 1
    else:
        n_past = rng.integers(1, top + 1, B)
        n_past[1] = top
    n_past[0] = 0
    return paged_pool(kv, page, n_past, hkv, rep, alibi, rng, dev, D, layers)


def paged_pool(kv, page, n_past, hkv, rep, alibi, rng, dev, d, layers):
    """`paged_inputs` for the given n_past [B] and head dim `d`."""
    from llm_tpu_torch.ops.layers import alibi_slopes

    B = len(n_past)
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
    shape = (layers, NP, hkv, page, d)
    ks = vs = None
    if kv in ("int8", "int4"):
        lo, hi, dt = (-127, 128, torch.int8) if kv == "int8" else \
            (0, 256, torch.uint8)
        cshape = shape if kv == "int8" else shape[:-1] + (d // 2,)
        pk = torch.randint(lo, hi, cshape, generator=g, device=dev, dtype=dt)
        pv = torch.randint(lo, hi, cshape, generator=g, device=dev, dtype=dt)
        ks = torch.rand(shape[:-1], generator=g, device=dev) * 0.02
        vs = torch.rand(shape[:-1], generator=g, device=dev) * 0.02
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        pk = torch.randn(shape, generator=g, device=dev).to(dt)
        pv = torch.randn(shape, generator=g, device=dev).to(dt)
    qf = torch.randn((B, 1, hkv, rep, d), generator=g, device=dev)
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
    ok, errs = attn_held(got, ref, npast)
    rec = {"case": name, "kv": kv, "page": page, "B": B, "Hkv": hkv,
           "rep": rep, "alibi": alibi, "window_pages": wp,
           "n_past_max": int(npast.max()), "n_past_sum": int(npast.sum()),
           "ok": bool(ok), "max_abs_err": max(errs), "errs_m_l_acc": errs}
    plan = pa.launch_plan(B, hkv, rep, D, page, wp * page, pk.dtype,
                          num_sms())
    rec["plan"] = dict(plan._asdict(), smem=plan.smem.total)
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


# the kernel away from the 7B shapes: head dims 64 / 80 / 256, 4 / 8 / 71
# query heads a kv head (71: Falcon-7B's one kv head), page 24 (no
# power-of-two chunk), all four pools, with and without ALiBi; streams with
# no past, mid-page, a full window and one position
MATRIX_D = (64, 80, 256)
MATRIX_REP = (4, 8, 71)
MATRIX_PAGE = 24
POOLS = ("bf16", "f32", "int8", "int4")


def matrix_case(kv, d, rep, alibi, n_past, rng, dev) -> dict:
    from types import SimpleNamespace

    from llm_tpu_torch.ops import paged_attention as pa

    hkv = 1 if rep == 71 else 2
    page = MATRIX_PAGE
    pk, pv, ks, vs, tables, npast, slopes, wp, qf = paged_pool(
        kv, page, np.asarray(n_past), hkv, rep, alibi, rng, dev, d, 2)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(d))
    args = (spec, pk, pv, ks, vs, tables, npast, slopes, wp, 1, qf)
    got = pa.paged_attention_pass(*args)
    torch.cuda.synchronize()
    ok, errs = attn_held(got, pa.paged_attention_plain(*args), npast)
    plan = pa.launch_plan(len(n_past), hkv, rep, d, page, wp * page,
                          pk.dtype, num_sms())
    return {"case": "matrix", "kv": kv, "D": d, "rep": rep, "Hkv": hkv,
            "alibi": alibi, "page": page, "B": len(n_past),
            "tile": plan.tile, "tps": plan.tps, "pipe": plan.pipe,
            "vec": plan.vec, "ok": bool(ok),
            "max_abs_err": max(errs), "errs_m_l_acc": errs}


def dense_matrix_case(kv, d, rep, rng, dev) -> dict:
    """The dense cache at head dim d: S = 100 positions, window 100."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops.layers import alibi_slopes

    S, hkv, n_past = 100, 2, [0, 37, 100]
    shape = (2, len(n_past), hkv, S, d)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    ks = vs = None
    if kv == "int8":
        ck, cv = (torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=g, device=dev) * 0.02
                  for _ in range(2))
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        ck, cv = (torch.randn(shape, generator=g, device=dev).to(dt)
                  for _ in range(2))
    qf = torch.randn((len(n_past), 1, hkv, rep, d), generator=g, device=dev)
    npast = torch.tensor(n_past, dtype=torch.int32, device=dev)
    slopes = alibi_slopes(hkv * rep, 8.0, dev).reshape(hkv, rep)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(d))
    args = (spec, ck, cv, ks, vs, npast, S, 1, qf, slopes)
    got = da.dense_attention_pass(*args)
    torch.cuda.synchronize()
    ok, errs = attn_held(got, da.dense_attention_plain(*args), npast)
    return {"case": "matrix_dense", "kv": kv, "D": d, "rep": rep,
            "alibi": True, "W": S, "ok": bool(ok), "max_abs_err": max(errs),
            "errs_m_l_acc": errs}


def attention_matrix(dev) -> list[dict]:
    rng = np.random.default_rng(7)
    full = 4 * MATRIX_PAGE
    recs = [matrix_case(kv, d, rep, alibi, [0, MATRIX_PAGE + 5, full, 1],
                        rng, dev)
            for d in MATRIX_D for rep in MATRIX_REP for kv in POOLS
            for alibi in (False, True)]
    # 160 streams: few splits a stream, each a loop over several tiles
    many = [(0, MATRIX_PAGE + 5, 8 * MATRIX_PAGE, 1, 100)[i % 5]
            for i in range(160)]
    recs += [matrix_case(kv, 80, 4, True, many, rng, dev) for kv in POOLS]
    recs += [dense_matrix_case(kv, d, 4, rng, dev) for d in MATRIX_D
             for kv in ("bf16", "f32", "int8")]
    torch.cuda.empty_cache()
    return recs


def check_repeat(dev) -> dict:
    """Two launches on the same inputs, and a launch after one with
    another grid, give bit-equal m, l and acc: the chunks merge in a fixed
    order, and every ticket is back at 0 after a launch."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(8)
    spec = SimpleNamespace(kq_scale=1.0 / math.sqrt(D))
    layers = PAGED_LAYER + 1

    def paged(inputs):
        pk, pv, ks, vs, tables, npast, slopes, wp, qf = inputs
        return lambda: pa.paged_attention_pass(
            spec, pk, pv, ks, vs, tables, npast, slopes, wp, PAGED_LAYER, qf)

    a = paged(paged_inputs("bf16", 256, 64, ("at", 200), H, 1, False, rng,
                           dev, layers))
    b = paged(paged_inputs("int8", 16, 16, ("upto", 2000), H, 1, False, rng,
                           dev, layers))
    g = torch.Generator(device=dev).manual_seed(9)
    ck = torch.randn((2, 1, H, CTX, D), generator=g, device=dev).bfloat16()
    cv = torch.randn((2, 1, H, CTX, D), generator=g, device=dev).bfloat16()
    qf = torch.randn((1, 1, H, 1, D), generator=g, device=dev)
    npast = torch.tensor([CTX - 7], dtype=torch.int32, device=dev)

    def dense(W):
        return lambda: da.dense_attention_pass(spec, ck, cv, None, None,
                                               npast, W, 1, qf)

    out = {"case": "repeat", "ok": True}
    for name, fn, other in (("paged", a, b), ("dense", dense(512),
                                               dense(2048))):
        first, second = fn(), fn()
        other()
        third = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(first, second, third))
        out[name] = bool(same)
        out["ok"] = out["ok"] and same
    out["max_abs_err"] = 0.0 if out["ok"] else float("nan")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path end to end


@contextlib.contextmanager
def plain_versions(bf16: bool = False, halves: bool = False):
    """Route every wrapper's CUDA calls to its plain version (the
    reference run of this script only; the port itself never does this).
    `bf16`: qmatmul's plain version rounds x and the dequantized weight to
    bf16 first, as the kernel does (f32 products and sums); `halves`: it
    then sums the two halves of K apart, the same products in another
    order."""
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
    from llm_tpu_torch.ops import qmatmul as qm

    saved = qm.qmatmul_cuda, da.dense_attention_cuda, pa.paged_attention_cuda
    qm.qmatmul_cuda = qm.qmatmul_plain
    if bf16:
        def bf16_plain(x, w):
            xb, wd = x.bfloat16().float(), dequant_any(w).bfloat16().float()
            if not halves:
                return xb @ wd
            k = xb.shape[1] // 2
            return xb[:, :k] @ wd[:k] + xb[:, k:] @ wd[k:]

        qm.qmatmul_cuda = bf16_plain
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


def greedy_prompt_run(model, prompt: list[int], n: int = N_PREDICT) -> dict:
    """`n` greedy tokens after `prompt` (EoT banned) through the session,
    and the run's times."""
    from llm_tpu_torch import session as S
    from llm_tpu_torch.samplers import build_sampler_chain

    sess = S.InferenceSession(model, S.InferenceSessionConfig(
        memory_k_type=S.ModelKVMemoryType.Float16,
        memory_v_type=S.ModelKVMemoryType.Float16, n_batch=N_BATCH))
    chain = build_sampler_chain(["topk:k=1"],
                                bias=[(model.eot_token_id(), float("-inf"))])
    stats = sess.infer(
        S.InferenceRequest(prompt=prompt, maximum_token_count=n,
                           parameters=S.InferenceParameters(sampler=chain)),
        rng=np.random.default_rng(0))
    new = sess.tokens[len(prompt):]
    if len(new) != n or stats.prompt_tokens != len(prompt):
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
        "first_new_ids": new[:8], "new_ids": new,
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
    attention_launches_held("infer decode", out, spec)
    return out


def attention_launches_held(name, profile, spec) -> None:
    """A profiled decode step launches the attention kernel once a layer."""
    got = profile["attention_launches_per_step"]
    if got != spec.n_layer:
        fail(f"{name}: {got} attention kernels a profiled decode step, "
             f"not {spec.n_layer}")


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
        "attention_launches_per_step": sum(
            c for k, (_, c) in by_name.items() if ATTN_KERNEL in k) / steps,
        "top_device": [{"kernel": k[:80], "ms_per_step": t / 1e3 / steps,
                        "launches_per_step": c / steps}
                       for k, (t, c) in top[:8]],
    }


def e2e_prompts() -> list[list[int]]:
    """The e2e phase's prompts (PROMPT_LENS tokens, seed 3)."""
    rng = np.random.default_rng(3)
    return [rng.integers(1, V, n).tolist() for n in PROMPT_LENS]


def e2e_phase(dev):
    from llm_tpu_torch import loader
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.testing import make_bench_file

    out = {}
    path = bench_path()
    path.parent.mkdir(parents=True, exist_ok=True)
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
    except BaseException:
        path.unlink(missing_ok=True)
        raise
    spec = model.spec
    if (spec.n_embd, spec.n_head, spec.n_layer, spec.n_vocab) != \
            (E, H, N_LAYER, V):
        fail(f"loaded spec {spec}")
    out["weights_bytes"] = torch.cuda.memory_allocated(dev)

    prompts = e2e_prompts()
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
    # decode-shaped and reads the cache through the attention kernel too;
    # every other chunk runs 512 rows
    steps = sum(math.ceil(n / N_BATCH) + N_PREDICT for n in PROMPT_LENS)
    decode_steps = sum(N_PREDICT + (n % N_BATCH == 1) for n in PROMPT_LENS)
    out["launches_expected"] = path_launches(
        "infer", launches, steps, steps - decode_steps, decode_steps, spec)
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


# ---------------------------------------------------------------------------
# phase 3b: on-device sampling, the decode step as a CUDA graph


DS_STEPS = 8  # --decode-steps of the phase's runs: 4 blocks of 32 tokens


def step_launches(spec, attention: str = "dense_attention") -> dict:
    """The kernel launches of one T=1 forward of `spec`: qmatmul 4 a layer
    (q|k|v, wo, the FFN's up or gate|up, down) and the head, the
    `attention` kernel once a layer (LLaMA-7B: 129 and 32), the other
    attention kernel never."""
    want = {"qmatmul": 4 * spec.n_layer + 1, "dense_attention": 0,
            "paged_attention": 0}
    want[attention] = spec.n_layer
    return want


def ds_session(model):
    from llm_tpu_torch import session as S

    return S.InferenceSession(model, S.InferenceSessionConfig(
        memory_k_type=S.ModelKVMemoryType.Float16,
        memory_v_type=S.ModelKVMemoryType.Float16, n_batch=N_BATCH))


def ds_samplers(model) -> dict:
    """The phase's DeviceSamplers, each with EoT banned as the e2e phase
    bans it. "greedy" is the device form of the e2e phase's host chain
    `topk:k=1`, whose default slots put Repetition (1.3 over the last 64
    tokens) before the top-k."""
    from llm_tpu_torch.ops.sampling import DeviceSampler

    ban = ((model.eot_token_id(), float("-inf")),)
    return {
        "greedy": DeviceSampler(kind="greedy", repeat_penalty=1.3,
                                penalty_last_n=64, bias=ban),
        "topk_penalty": DeviceSampler(kind="sample", temperature=0.8,
                                      top_k=40, repeat_penalty=1.3, bias=ban),
        "mirostat2": DeviceSampler(kind="sample", temperature=0.8, mirostat=2,
                                   bias=ban),
    }


def graph_records(sess) -> list[dict]:
    """What each decode graph of a session's cache recorded."""
    return [{"window": key[1], "capacity": key[-1], "capture_s": g.capture_s,
             "pool_bytes": g.pool_bytes, "launches_per_replay": g.launches,
             "replays": g.replays}
            for key, g in sess.cache.graphs.items()]


def launches_held(name, recs, spec) -> None:
    """Every capture counted one forward's launches (`step_launches`:
    LLaMA-7B's 129 qmatmul and 32 attention)."""
    want = step_launches(spec)
    for r in recs:
        if r["launches_per_replay"] != want:
            fail(f"{name}: a captured decode step counted "
                 f"{r['launches_per_replay']} launches, not {want}")


def replay_vs_eager(model, prompt, sampler, dev) -> dict:
    """One decode step after `prompt`, eagerly and as a captured graph
    replay, on the same state and uniforms: logits and token bit-equal."""
    from llm_tpu_torch.models.forward import decode_loop, window_bucket
    from llm_tpu_torch.ops.sampling import penalty_state

    spec = model.spec
    sess = ds_session(model)
    sess.feed_prompt(prompt)
    n = sess.n_past
    window = window_bucket(n + 1, spec.n_ctx)
    u = None
    if sampler.kind != "greedy":
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        u = torch.rand((1, spec.n_vocab), generator=gen,
                       device=dev).clamp_min_(1e-20)
    pst = None
    if sampler.has_penalties:
        pst = {k: v[0] for k, v in penalty_state(
            [sess.tokens], sampler.penalty_last_n, spec.n_vocab,
            device=dev).items()}
    outs = [decode_loop(spec, model.params, sess.last_logits, n, sess.cache,
                        1, window, sampler, penalty_state=pst, uniforms=u,
                        graph=graph) for graph in (False, True)]
    torch.cuda.synchronize()
    (te, le, _, _), (tg, lg, _, _) = outs
    rec = {"token": int(tg[0]), "eager_token": int(te[0]),
           "logits_bit_equal": bool(torch.equal(le, lg)),
           "max_abs_diff": float((le - lg).abs().max()),
           "graphs": graph_records(sess)}
    if not bool(torch.isfinite(lg).all()):
        fail("device sampling: non-finite logits from the replay")
    if int(te[0]) != int(tg[0]) or not rec["logits_bit_equal"]:
        fail(f"device sampling: replay differs from the eager step: {rec}")
    launches_held("replay_vs_eager", rec["graphs"], spec)
    return rec


def events_ms(fn) -> tuple[float, float]:
    """(device ms by CUDA events, host wall ms) of fn(), which ends with
    the host reading its result."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), 1e3 * (time.monotonic() - t0)


def device_sampling_phase(model, dev, e2e) -> dict:
    """`infer_device` on the loaded 7B model (no second load): the replay
    of a captured decode step against the eager step; greedy tokens of the
    e2e prompts against the e2e phase's host-sampled ones; seeded sampled
    runs that repeat and a mirostat-2 run; decode ms a token of the device
    path and of host-sampled `infer` in the same run (CUDA events), the
    busy share of a profiled block, graph capture seconds and pool bytes,
    launches and replays a token."""
    from llm_tpu_torch.samplers import build_sampler_chain

    out = {}
    smp = ds_samplers(model)
    prompts = e2e_prompts()
    mid = prompts[1]  # the 64-token prompt
    out["replay_vs_eager"] = {name: replay_vs_eager(model, mid, smp[name],
                                                    dev)
                              for name in ("greedy", "topk_penalty")}

    # greedy tokens equal the host-sampled e2e runs'
    runs, graphs = [], []
    for prompt, host in zip(prompts, e2e["runs"]):
        sess = ds_session(model)
        dev_ms, wall_ms = events_ms(lambda: sess.infer_device(
            prompt, N_PREDICT, sampler=smp["greedy"], n_steps=DS_STEPS,
            halt_on_eot=False))
        new = sess.tokens[len(prompt):]
        recs = graph_records(sess)
        runs.append({"prompt_tokens": len(prompt), "new_ids": new,
                     "call_device_ms": dev_ms, "call_wall_ms": wall_ms,
                     "graphs": recs})
        graphs += recs
        if new != host["new_ids"]:
            fail(f"device sampling, prompt of {len(prompt)}: greedy tokens "
                 f"{new} != host-sampled {host['new_ids']}")
        if not np.isfinite(sess.last_logits).all():
            fail("device sampling: non-finite logits")
        del sess
    launches_held("greedy runs", graphs, model.spec)
    out["greedy_runs"] = runs

    # decode ms a token, device path against host-sampled infer, steady
    # state (graphs captured before the timed calls), the 64-token prompt
    timing = {}
    for steps in (DS_STEPS, 32):
        sess = ds_session(model)
        sess.infer_device(mid, steps, sampler=smp["greedy"], n_steps=steps,
                          halt_on_eot=False)  # captures
        before = sum(g.replays for g in sess.cache.graphs.values())
        dev_ms, wall_ms = events_ms(lambda: sess.infer_device(
            [], N_PREDICT, sampler=smp["greedy"], n_steps=steps,
            halt_on_eot=False))
        replays = sum(g.replays for g in sess.cache.graphs.values()) - before
        timing[f"device_steps{steps}"] = {
            "ms_per_token": dev_ms / N_PREDICT,
            "wall_ms_per_token": wall_ms / N_PREDICT,
            "replays_per_token": replays / N_PREDICT,
            "launches_per_token": sum(step_launches(model.spec).values())
            * replays / N_PREDICT,
            "graphs": graph_records(sess)}
        if steps == 32:
            block = step_profile(lambda: sess.infer_device(
                [], 32, sampler=smp["greedy"], n_steps=32,
                halt_on_eot=False), steps=2)
            busy = block["device_busy_share"]
            per = {
                "wall_ms_per_token": block["wall_ms_per_step"] / 32,
                "device_ms_per_token": (block["device_ms_per_step"] / 32
                                        if busy is not None else None),
                "device_busy_share": busy,
                "device_launches_per_token":
                    block["device_launches_per_step"] / 32,
                "attention_launches_per_token":
                    block["attention_launches_per_step"] / 32,
                "top_device": [{"kernel": r["kernel"],
                                "ms_per_token": r["ms_per_step"] / 32,
                                "launches_per_token":
                                    r["launches_per_step"] / 32}
                               for r in block["top_device"]],
                "busy_share_how": (
                    "union of the kernel intervals torch.profiler recorded "
                    "over two 32-token blocks, over the untraced wall time "
                    "of a block" if busy is not None else
                    "not measured: torch.profiler recorded no kernel of the "
                    "graph replays"),
            }
            timing["profile_per_token"] = per
        del sess
    host = ds_session(model)
    chain = build_sampler_chain(["topk:k=1"],
                                bias=[(model.eot_token_id(), float("-inf"))])
    host.feed_prompt(mid)
    rng = np.random.default_rng(0)
    from llm_tpu_torch.session import InferenceParameters

    params = InferenceParameters(sampler=chain)
    host.infer_next_token(rng, params)  # warm
    dev_ms, wall_ms = events_ms(lambda: [host.infer_next_token(rng, params)
                                         for _ in range(N_PREDICT)])
    timing["host_infer"] = {"ms_per_token": dev_ms / N_PREDICT,
                            "wall_ms_per_token": wall_ms / N_PREDICT}
    del host
    out["timing"] = timing
    caps = [g for t in (timing["device_steps8"], timing["device_steps32"])
            for g in t["graphs"]]
    prof = timing["profile_per_token"]
    out["summary"] = {
        "device_ms_per_token": {
            f"steps{n}": timing[f"device_steps{n}"]["ms_per_token"]
            for n in (DS_STEPS, 32)},
        "host_infer_ms_per_token": timing["host_infer"]["ms_per_token"],
        "replays_per_token": timing["device_steps32"]["replays_per_token"],
        "k1_k2_launches_per_token":
            timing["device_steps32"]["launches_per_token"],
        "profiled_launches_per_token": prof["device_launches_per_token"],
        "device_busy_share": prof["device_busy_share"],
        "busy_share_how": prof["busy_share_how"],
        "capture_s": [g["capture_s"] for g in caps],
        "pool_bytes": [g["pool_bytes"] for g in caps],
    }
    emit({"device_sampling_summary": out["summary"]})

    # seeded sampled runs repeat; mirostat 2 ends with a finite mu
    sampled = []
    for _ in range(2):
        sess = ds_session(model)
        sess.infer_device(mid, N_PREDICT, sampler=smp["topk_penalty"],
                          n_steps=DS_STEPS, seed=1, halt_on_eot=False)
        sampled.append(sess.tokens[len(mid):])
        launches_held("sampled run", graph_records(sess), model.spec)
        del sess
    out["sampled_ids"] = sampled
    if sampled[0] != sampled[1] or len(sampled[0]) != N_PREDICT:
        fail(f"device sampling: seeded runs differ: {sampled}")
    sess = ds_session(model)
    sess.infer_device(mid, N_PREDICT, sampler=smp["mirostat2"],
                      n_steps=DS_STEPS, seed=1, halt_on_eot=False)
    out["mirostat2"] = {"new_ids": sess.tokens[len(mid):],
                        "mu": sess._mirostat_mu}
    launches_held("mirostat run", graph_records(sess), model.spec)
    if not math.isfinite(sess._mirostat_mu):
        fail(f"device sampling: mirostat mu {sess._mirostat_mu}")
    del sess
    torch.cuda.empty_cache()
    return out


COALESCED_NEW = 16


def coalesced_infer_phase(model, dev) -> dict:
    """`infer` on the same 7B model with its layer weights coalesced on the
    card (`coalesce_layer_weights`; lm_head stays planes): the greedy
    tokens of the plane run, and with the counters zeroed just before and
    read just after this run alone, 129 qmatmul launches a forward of which
    128 (4 projections x 32 layers) over the coalesced buffers."""
    import copy

    from llm_tpu_torch.models.params import coalesce_layer_weights
    from llm_tpu_torch.ops import qmatmul as qm
    from llm_tpu_torch.ops.packing import QuantTensorC

    out = {}
    prompt = np.random.default_rng(8).integers(1, V, 64).tolist()
    plane_tokens = greedy_prompt_run(model, prompt, COALESCED_NEW)["new_ids"]
    t0 = time.monotonic()
    cmodel = copy.copy(model)
    cmodel.params = coalesce_layer_weights(model.params)
    torch.cuda.synchronize()
    out["coalesce_s"] = time.monotonic() - t0
    lw = cmodel.params.layers
    if not all(isinstance(getattr(lw, f), QuantTensorC)
               for f in ("w_qkv", "wo", "w_gate_up", "w_down")):
        fail("coalesce_layer_weights left a 7B layer weight in planes")
    out["tiles"] = {f: [getattr(lw, f).tile_k, getattr(lw, f).tile_r,
                        getattr(lw, f).kp, getattr(lw, f).rp,
                        getattr(lw, f).scale_packed]
                    for f in ("w_qkv", "wo", "w_gate_up", "w_down")}
    zero_launches()
    run = greedy_prompt_run(cmodel, prompt, COALESCED_NEW)
    launches = read_launches()
    launches["qmatmul_coalesced"] = qm.LAUNCHES_COALESCED
    tokens = run.pop("new_ids")
    out["run"] = run
    forwards = math.ceil(len(prompt) / N_BATCH) + COALESCED_NEW
    per = 4 * N_LAYER + 1  # the prompt: one chunk of 512 rows
    want = {"qmatmul": per * forwards,
            "qmatmul_swapped": per * COALESCED_NEW,
            "qmatmul_wide": per * (forwards - COALESCED_NEW),
            "dense_attention": N_LAYER * COALESCED_NEW, "paged_attention": 0,
            "qmatmul_coalesced": 4 * N_LAYER * forwards}
    out.update(tokens=tokens, plane_tokens=plane_tokens, launches=launches,
               launches_expected=want)
    if tokens != plane_tokens:
        fail(f"coalesced infer tokens {tokens} != plane run's {plane_tokens}")
    if launches != want:
        fail(f"coalesced infer launches {launches}, expected {want}")
    del cmodel, lw
    torch.cuda.empty_cache()
    return out


def compare_logits(name, got, ref) -> dict:
    """Relative L2 and top-1 agreement of two logits tensors [.., V]; fails
    the run past E2E_REL_L2."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
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
    [B, T]): all of them, the decode-shaped ones (T = 1), and those whose
    B * T rows take qmatmul's wide path."""
    from llm_tpu_torch.ops import qmatmul as qm

    inner = getattr(module, name)
    counts = {"forwards": 0, "t1_forwards": 0, "wide_forwards": 0}

    def wrapped(spec, params, ids, *a, **k):
        counts["forwards"] += 1
        counts["t1_forwards"] += ids.shape[-1] == 1
        counts["wide_forwards"] += ids.numel() > qm.SWAPPED_MAX_M
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
    from llm_tpu_torch.ops import qmatmul_probe as qp

    qm.LAUNCHES = da.LAUNCHES = pa.LAUNCHES = 0
    qm.LAUNCHES_COALESCED = qp.LAUNCHES = 0
    qm.LAUNCHES_SWAPPED = qm.LAUNCHES_WIDE = 0


def read_launches() -> dict:
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
    from llm_tpu_torch.ops import qmatmul as qm

    return {"qmatmul": qm.LAUNCHES, "qmatmul_swapped": qm.LAUNCHES_SWAPPED,
            "qmatmul_wide": qm.LAUNCHES_WIDE,
            "dense_attention": da.LAUNCHES, "paged_attention": pa.LAUNCHES}


def check_engine_launches(name, launches, counts, attention, spec) -> dict:
    """Exact launch counts of one engine run of `spec`: `step_launches`'s
    qmatmul launches (4 projections x n_layer + the head: LLaMA-7B's 129)
    per forward, on the wide path for the forwards of more than 32 rows and
    on the swapped path for the rest, n_layer launches of the engine's
    `attention` kernel per decode-shaped forward (the T=1 ones; longer
    prefill chunks take its plain page pass or the torch prefill
    attention), and none of the other attention kernel."""
    one = step_launches(spec, attention)
    per = one["qmatmul"]
    want = {"qmatmul": per * counts["forwards"],
            "qmatmul_swapped": per * (counts["forwards"]
                                      - counts["wide_forwards"]),
            "qmatmul_wide": per * counts["wide_forwards"],
            "dense_attention": 0, "paged_attention": 0}
    want[attention] = one[attention] * counts["t1_forwards"]
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
    attention_launches_held(type(engine).__name__, out, engine.model.spec)
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
        "texts": [r["text"] for r in results],
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
            # not the warm-up's
            counts.update(forwards=0, t1_forwards=0, wide_forwards=0)
            dispatches0 = engine.decode_dispatches
            out.update(http_traffic(srv, log, rng, greedy))
        finally:
            srv.shutdown()  # the engine thread has stopped when it returns
    launches = read_launches()
    paged_dispatches = engine.decode_dispatches - dispatches0
    out["paged_launches"] = launches
    out["paged_forwards"] = dict(counts, decode_dispatches=paged_dispatches)
    check_engine_launches("paged engine", launches, counts,
                          "paged_attention", model.spec)
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
                          "dense_attention", model.spec)
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
# phase 4b: multi-step serving, the batched T=1 step as a CUDA graph


MS_STEPS = 16  # tokens a block (--multi-step 16)
MS_DENSE_STREAMS = 8
MS_B64, MS_B64_PAST = 64, 200  # the reference bench's paged-serve-64 row
MS_TIMED_BLOCKS = 3


def weight_traffic(model) -> tuple[int, float]:
    """(bytes of every matmul weight's planes, FLOPs of one token through
    them): what a decode step must read once, and compute per stream."""
    from dataclasses import fields as dc_fields

    from llm_tpu_torch.ops.packing import QuantTensor

    params = model.params
    ws = [(getattr(params.layers, f.name), model.spec.n_layer)
          for f in dc_fields(params.layers)]
    ws.append((params.lm_head if params.lm_head is not None else params.wte,
               1))
    ws = [(w, n) for w, n in ws if isinstance(w, QuantTensor)]
    return (sum(plane_bytes(w) for w, _ in ws),
            sum(2.0 * w.k * w.r * n for w, n in ws))


def kv_row_bytes(kv: str, spec) -> int:
    """Bytes of one position's K and V rows over every layer and kv head."""
    per = {"int8": spec.head_dim + 4, "bf16": 2 * spec.head_dim}[kv]
    return 2 * spec.n_layer * spec.n_head_kv * per


def graph_stats(graphs: dict) -> list[dict]:
    return [{"key": [str(k) for k in key[:3]], "capture_s": g.capture_s,
             "pool_bytes": g.pool_bytes, "launches_per_replay": g.launches,
             "replays": g.replays} for key, g in graphs.items()]


def ms_launches_held(name, recs, attention, spec) -> None:
    """Every capture of a batched step counted one forward's launches
    (`step_launches`: LLaMA-7B's 129 qmatmul and 32 of the engine's
    attention kernel), and none of the other attention kernel."""
    want = step_launches(spec, attention)
    for r in recs:
        if r["launches_per_replay"] != want:
            fail(f"{name}: a captured batched step counted "
                 f"{r['launches_per_replay']} launches, not {want}")


def loop_run(name, block, graphs, B, attention, kv_bytes, model) -> dict:
    """Time a decode loop over whole blocks: `block()` runs one block of
    MS_STEPS tokens and reads its tokens on the host. The first call
    captures; MS_TIMED_BLOCKS more are timed by CUDA events, then one is
    profiled (the profiler's own host time grows with the ~80,000 kernels
    a block). Holds each capture's launches and the replays a block."""
    block()
    replays0 = sum(g.replays for g in graphs.values())
    ms = [events_ms(block)[0] for _ in range(MS_TIMED_BLOCKS)]
    replays = sum(g.replays for g in graphs.values()) - replays0
    prof = step_profile(block, steps=1)
    recs = graph_stats(graphs)
    ms_launches_held(name, recs, attention, model.spec)
    if replays != MS_STEPS * MS_TIMED_BLOCKS:
        fail(f"{name}: {replays} replays for {MS_TIMED_BLOCKS} blocks of "
             f"{MS_STEPS}")
    wbytes, wflops = weight_traffic(model)
    bound, by = bound_ms(wbytes + kv_bytes, wflops * B)
    step_ms = float(np.median(ms)) / MS_STEPS
    busy = prof["device_busy_share"]
    return {
        "streams": B, "n_steps": MS_STEPS, "block_ms": ms,
        "ms_per_step": step_ms, "tok_s": B * 1e3 / step_ms,
        "bound_ms_per_step": bound, "bound_by": by,
        "bound_bytes": wbytes + kv_bytes,
        "replays_per_block": replays / MS_TIMED_BLOCKS,
        "launches_per_block": {k: v * MS_STEPS for k, v in
                               recs[-1]["launches_per_replay"].items()},
        "device_busy_share": busy,
        "device_ms_per_step": (prof["device_ms_per_step"] / MS_STEPS
                               if busy is not None else None),
        "profiled_launches_per_step":
            prof["device_launches_per_step"] / MS_STEPS,
        "top_device": prof["top_device"],
        "graphs": recs,
    }


def greedy_block_sampler(model):
    from llm_tpu_torch.ops.sampling import DeviceSampler

    return DeviceSampler(kind="greedy", repeat_penalty=1.3,
                         penalty_last_n=64,
                         bias=((model.eot_token_id(), float("-inf")),))


def hand_pool(model, dev, n_past, n_new: int):
    """An int8 pool of page 256 and hand-built tables (the bench's form):
    each stream the pages its n_past + n_new need, the pool exactly those
    plus the trash page 0. Returns (pool, tables [B, n_ctx/page], the
    window pages)."""
    from llm_tpu_torch.paged import init_paged_cache

    need = [-(-(int(n) + n_new) // SERVE_PAGE) for n in n_past]
    pool = init_paged_cache(model.spec, 1 + sum(need), SERVE_PAGE, "int8",
                            dev)
    tables = np.zeros((len(need), model.spec.n_ctx // SERVE_PAGE), np.int32)
    nxt = 1
    for b, n in enumerate(need):
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return pool, tables, max(need)


def paged_loop_case(model, dev, B, n_past, name) -> dict:
    """`paged_decode_loop` over `hand_pool`'s int8 pool, every stream
    decoding MS_STEPS tokens a block."""
    from llm_tpu_torch.ops.sampling import penalty_state
    from llm_tpu_torch.paged import paged_decode_loop

    pool, tables, wp = hand_pool(model, dev, n_past, MS_STEPS)
    n_past = np.asarray(n_past, np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    Vm = model.spec.n_vocab
    logits = torch.randn((B, Vm), generator=gen, device=dev)
    sampler = greedy_block_sampler(model)
    pst = penalty_state([[] for _ in range(B)], 64, Vm)

    def block():
        toks = paged_decode_loop(model.spec, model.params, logits, n_past,
                                 tables, pool, MS_STEPS, wp, sampler,
                                 penalty_state=pst)[0]
        return toks.cpu()

    out = loop_run(name, block, pool.graphs, B, "paged_attention",
                   int(n_past.sum()) * kv_row_bytes("int8", model.spec), model)
    out.update(kv="int8", page=SERVE_PAGE, window_pages=wp,
               n_past=[int(x) for x in n_past], pool_bytes=pool.nbytes())
    del pool
    torch.cuda.empty_cache()
    return out


def dense_loop_case(model, dev) -> dict:
    """`decode_loop_batched` over a bf16 dense cache of 8 streams at the
    serve8 positions, every slot writing."""
    from llm_tpu_torch.models.forward import (
        decode_loop_batched,
        init_cache_batched,
        window_bucket,
    )
    from llm_tpu_torch.ops.sampling import penalty_state

    B = MS_DENSE_STREAMS
    cache = init_cache_batched(model.spec, B, torch.bfloat16, dev)
    n_past = np.asarray(SERVE8_N_PAST, np.int32)
    window = window_bucket(int(n_past.max()) + MS_STEPS, CTX)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    logits = torch.randn((B, V), generator=gen, device=dev)
    sampler = greedy_block_sampler(model)
    pst = penalty_state([[] for _ in range(B)], 64, V)
    mask = torch.ones(B, dtype=torch.bool, device=dev)

    def block():
        toks = decode_loop_batched(model.spec, model.params, logits, n_past,
                                   cache, MS_STEPS, window, sampler,
                                   write_mask=mask, penalty_state=pst)[0]
        return toks.cpu()

    out = loop_run("dense bf16 B=8", block, cache.graphs, B,
                   "dense_attention",
                   int(n_past.sum()) * kv_row_bytes("bf16", model.spec),
                   model)
    out.update(kv="bf16", window=window, n_past=[int(x) for x in n_past])
    del cache
    torch.cuda.empty_cache()
    return out


def replay_vs_eager_batched(model, dev) -> dict:
    """One batched step captured and replayed against the same step run
    eagerly (graph=False) on the same state: tokens and logits bit-equal.
    Paged int8 (16 streams) greedy and with a heterogeneous sampled mix;
    dense bf16 (8 streams) with a masked slot, whose rows must stay."""
    from llm_tpu_torch.models.forward import (
        decode_loop_batched,
        init_cache_batched,
    )
    from llm_tpu_torch.ops.sampling import (
        DeviceSampler,
        batched_sampler,
        penalty_state,
    )
    from llm_tpu_torch.paged import paged_decode_loop

    eot = model.eot_token_id()
    B = SERVE_STREAMS
    rng = np.random.default_rng(9)
    n_past = rng.integers(16, 700, B).astype(np.int32)
    pool, tables, wp = hand_pool(model, dev, n_past, 1)
    # random codes and scales: the pool pass reads real-looking rows
    for t in (pool.k, pool.v):
        t.copy_(torch.randint(-127, 128, t.shape, dtype=torch.int8,
                              device=dev))
    for t in (pool.k_scale, pool.v_scale):
        t.uniform_(0.001, 0.02)
    hist = [rng.integers(1, V, 40).tolist() for _ in range(B)]
    mix = []
    for b in range(B):
        if b % 4 == 0:
            mix.append(DeviceSampler(bias=((eot, float("-inf")),)))
        else:
            mix.append(DeviceSampler(
                kind="sample", temperature=0.5 + 0.1 * b, top_k=10 * (b % 3),
                top_p=1.0 if b % 2 else 0.9, repeat_penalty=1.0 + 0.05 * b,
                frequency_penalty=0.1 * (b % 2),
                bias=((eot, float("-inf")), (b, 2.0))))
    cfg, values = batched_sampler(mix, B, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    logits = torch.randn((B, V), generator=gen, device=dev) * 4
    u = torch.rand((1, B, V), generator=gen, device=dev).clamp_min_(1e-20)
    out = {}
    for name, sampler, vals, uni in (
            ("paged_int8_greedy", greedy_block_sampler(model), None, None),
            ("paged_int8_sampled", cfg, values, u)):
        pst = penalty_state(hist, sampler.penalty_last_n, V)
        runs = [paged_decode_loop(model.spec, model.params, logits, n_past,
                                  tables, pool, 1, wp, sampler,
                                  sampler_values=vals, penalty_state=pst,
                                  uniforms=uni, graph=g)
                for g in (False, True)]
        torch.cuda.synchronize()
        out[name] = replay_held(name, runs, pool.graphs, "paged_attention",
                                model.spec)
    del pool
    torch.cuda.empty_cache()

    Bd = MS_DENSE_STREAMS
    cache = init_cache_batched(model.spec, Bd, torch.bfloat16, dev)
    cache.k.normal_()
    cache.v.normal_()
    n_past = np.asarray(SERVE8_N_PAST, np.int32)
    mask = torch.tensor([b != 3 for b in range(Bd)], device=dev)
    slot3 = (cache.k[:, 3].clone(), cache.v[:, 3].clone())
    runs = [decode_loop_batched(model.spec, model.params, logits[:Bd],
                                n_past, cache, 1, 1024,
                                greedy_block_sampler(model),
                                write_mask=mask,
                                penalty_state=penalty_state(hist[:Bd], 64, V),
                                graph=g)
            for g in (False, True)]
    torch.cuda.synchronize()
    out["dense_bf16_masked"] = replay_held("dense_bf16_masked", runs,
                                           cache.graphs, "dense_attention",
                                           model.spec)
    if not (torch.equal(cache.k[:, 3], slot3[0])
            and torch.equal(cache.v[:, 3], slot3[1])):
        fail("multi_step: the masked slot's cache rows changed")
    del cache
    torch.cuda.empty_cache()
    return out


def replay_held(name, runs, graphs, attention, spec) -> dict:
    (te, le), (tg, lg) = ((r[0], r[1]) for r in runs)
    rec = {"tokens_equal": bool(torch.equal(te, tg)),
           "logits_bit_equal": bool(torch.equal(le, lg)),
           "max_abs_diff": float((le - lg).abs().max()),
           "graphs": graph_stats(graphs)}
    if not bool(torch.isfinite(lg).all()):
        fail(f"multi_step {name}: non-finite logits from the replay")
    if not (rec["tokens_equal"] and rec["logits_bit_equal"]):
        fail(f"multi_step {name}: replay differs from the eager step: {rec}")
    ms_launches_held(name, rec["graphs"], attention, spec)
    return rec


TOKEN = re.compile(r"<t(\d+)>")


def token_margin(model, prompt, common, kv="int8") -> dict:
    """The top-2 margin of the host chain's penalized logits (repetition
    1.3 over 64, EoT banned) where a stream's block-path text first left
    the host-stepped one: the row after prompt + the common tokens, from
    the prefill of a paged engine over a `kv` pool."""
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.serve import GenerationRequest

    chain = build_sampler_chain(
        ["topk:k=1"], bias=[(model.eot_token_id(), float("-inf"))])
    engine = PagedEngine(model, max_streams=1, page_size=SERVE_PAGE,
                         kv_dtype=kv, n_batch=64)
    engine.submit(GenerationRequest(prompt=prompt + common, max_tokens=1,
                                    sampler=chain))
    engine._admit()
    stream = engine.slots[0]
    for _ in range(-(-len(stream.prefill_queue) // 64)):  # no decode step
        engine._advance_prefills()
    if stream.prefilling:
        fail("multi_step: the margin's prefill did not finish")
    x = np.array(stream.last_logits, np.float32)
    for t in chain.transforms:  # the ban and the penalty, no truncation
        if type(t).__name__ in ("FlatBias", "Repetition"):
            x = t.apply(x, stream.tokens, None)
    top = np.sort(x[np.isfinite(x)])[-2:]
    return {"margin": float(top[1] - top[0]),
            "tolerance": E2E_REL_L2 * float(np.abs(top).max())}


def record_blocks(engine) -> list:
    """Log (block steps, seconds) of each engine.step_multi call."""
    log = []
    inner = engine.step_multi

    def timed(n_steps=16):
        steps0 = engine.multi_block_steps
        t0 = time.monotonic()
        events = inner(n_steps)
        log.append((engine.multi_block_steps - steps0,
                    time.monotonic() - t0))
        return events

    engine.step_multi = timed
    return log


def multi_step_server(model, serve) -> dict:
    """The serve phase's paged engine and traffic behind LlmServer with
    multi_step=16: texts against the host-stepped serve phase's."""
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.server import LlmServer

    eot = model.eot_token_id()
    greedy = {"max_tokens": SERVE_NEW, "temperature": 0,
              "logit_bias": {str(eot): -100},
              # the host chain's default repetition slot, as a device
              # sampler: both paths sample alike
              "repeat_penalty": 1.3}
    engine = PagedEngine(model, max_streams=SERVE_STREAMS,
                         page_size=SERVE_PAGE, kv_dtype="int8", n_batch=64,
                         prefix_cache=True)
    srv = LlmServer(model, engine, host="127.0.0.1", port=0,
                    multi_step=MS_STEPS)
    rng = np.random.default_rng(4)  # the serve phase's prompts
    lens = rng.integers(16, 701, SERVE_STREAMS)
    prompts = [rng.integers(1, V, n).tolist() for n in lens]
    ref = serve["concurrent"]
    if [int(n) for n in lens] != ref["prompt_tokens"]:
        fail("multi_step: not the serve phase's prompts")
    bodies = [dict(greedy, prompt=p, stream=i < 4)
              for i, p in enumerate(prompts)]
    srv.start()
    try:
        srv.warmup()
        log = record_blocks(engine)
        zero_launches()
        url = "http://%s:%d/v1/completions" % srv.address
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.monotonic()
        with ThreadPoolExecutor(SERVE_STREAMS) as pool:
            results = list(pool.map(lambda b: http_completion(url, b),
                                    bodies))
        wall = time.monotonic() - t0
        launches = read_launches()
        ttft = np.array(srv.loop._ttft_ms)
    finally:
        srv.shutdown()
    errors = [r["finish"] for r in results if "error" in str(r["finish"])]
    if errors:
        fail(f"multi_step server: completions failed: {errors}")
    recs = graph_stats(engine.pool.graphs)
    ms_launches_held("multi_step server", recs, "paged_attention",
                     model.spec)
    replays = sum(r["replays"] for r in recs)
    if any(engine.multi_fallbacks.values()) or not engine.multi_blocks \
            or replays != engine.multi_block_steps:
        fail(f"multi_step server: blocks {engine.multi_blocks}, block steps "
             f"{engine.multi_block_steps}, replays {replays}, fallbacks "
             f"{engine.multi_fallbacks}")
    diffs = []
    for i, (r, want) in enumerate(zip(results, ref["texts"])):
        got_ids = [int(x) for x in TOKEN.findall(r["text"])]
        want_ids = [int(x) for x in TOKEN.findall(want)]
        if got_ids == want_ids:
            continue
        j = next(k for k, (a, b) in enumerate(zip(got_ids, want_ids))
                 if a != b)
        d = {"request": i, "step": j, **token_margin(model, prompts[i],
                                                      want_ids[:j])}
        emit({"multi_step_token_differs": d})
        diffs.append(d)
        if d["margin"] > d["tolerance"]:
            fail(f"multi_step server: request {i} differs from the "
                 f"host-stepped text at step {j}, top-2 margin "
                 f"{d['margin']:.4g} > {d['tolerance']:.4g}")
    blocks = [dt / n for n, dt in log if n]
    graph_launches = {k: sum(r["launches_per_replay"][k] * r["replays"]
                             for r in recs) for k in recs[0][
                                 "launches_per_replay"]}
    return {
        "requests": len(bodies), "wall_s": wall,
        "generated_tok_s": SERVE_STREAMS * SERVE_NEW / wall,
        "ttft_ms_median": float(np.median(ttft)),
        "ttft_ms_max": float(ttft.max()),
        "host_stepped_tok_s": ref["generated_tok_s"],
        "host_stepped_ttft_ms_median": ref["ttft_ms_median"],
        "host_stepped_ttft_ms_max": ref["ttft_ms_max"],
        "texts_equal": len(bodies) - len(diffs), "differs": diffs,
        "blocks": engine.multi_blocks,
        "block_steps": engine.multi_block_steps,
        "host_steps_during_run": sum(1 for n, _ in log if not n),
        "fallbacks": engine.multi_fallbacks,
        "ms_per_block_step_median": (1e3 * float(np.median(blocks))
                                     if blocks else None),
        # each block's wall ms a step, in order; a block that captured its
        # key's graph includes the warm-up steps and the capture
        "block_ms_per_step": [1e3 * b for b in blocks],
        "replays": replays, "graph_launches": graph_launches,
        "counted_launches": launches, "graphs": recs,
    }


def multi_step_phase(model, dev, serve) -> dict:
    """Multi-step serving on the 7B model: the server with multi_step=16
    against the host-stepped serve phase; the decode loops driven
    directly and timed over whole blocks (paged int8 at 16 and 64
    streams, dense bf16 at 8); one captured step against the eager step."""
    parts = {
        "server": lambda: multi_step_server(model, serve),
        "paged_int8_b16": lambda: paged_loop_case(
            model, dev, SERVE_STREAMS, serve["concurrent"]["prompt_tokens"],
            "paged int8 B=16"),
        "dense_bf16_b8": lambda: dense_loop_case(model, dev),
        "paged_int8_b64": lambda: paged_loop_case(
            model, dev, MS_B64, [MS_B64_PAST] * MS_B64, "paged int8 B=64"),
        "replay_vs_eager": lambda: replay_vs_eager_batched(model, dev),
    }
    out = {"part_s": {}}
    for name, run in parts.items():
        t0 = time.monotonic()
        out[name] = run()
        gc.collect()
        torch.cuda.empty_cache()
        out["part_s"][name] = time.monotonic() - t0
    keys = ("ms_per_step", "tok_s", "bound_ms_per_step", "replays_per_block",
            "launches_per_block", "device_busy_share", "device_ms_per_step")
    out["summary"] = {
        "server": {k: out["server"][k] for k in (
            "generated_tok_s", "ttft_ms_median", "ttft_ms_max",
            "host_stepped_tok_s", "host_stepped_ttft_ms_median",
            "host_stepped_ttft_ms_max", "blocks", "block_steps",
            "ms_per_block_step_median", "block_ms_per_step", "texts_equal",
            "fallbacks")},
        "part_s": out["part_s"],
        **{name: {**{k: out[name][k] for k in keys},
                  "capture_s": [g["capture_s"] for g in out[name]["graphs"]],
                  "pool_bytes": [g["pool_bytes"]
                                 for g in out[name]["graphs"]]}
           for name in ("paged_int8_b16", "dense_bf16_b8", "paged_int8_b64")},
    }
    emit({"multi_step_summary": out["summary"]})
    return out


# ---------------------------------------------------------------------------
# phase 4d: GGUF, perplexity, session snapshots and verify on the e2e model


PPL_CHUNKS = 4  # context windows (2048 tokens each) the perplexity reads
PPL_SUB = 512  # the session's sub-chunk: one forward of 512 rows
SNAP_HALF = 16  # greedy tokens before the snapshot, and after it
VERIFY_TOKENS = 32  # the Inference case's new tokens (its default: 128)
# Perplexity, kernel path against the plain path whose qmatmul rounds x and
# W to bf16 as the kernel does, on the same chunk: a token's NLL is
# lse(z) - z_t, a difference of logits, and the phases hold the logits to
# a relative 2^-8 (E2E_REL_L2); each of the two terms may carry that
# error, so the chunk's summed NLL is held to a relative 2 * 2^-8.
PPL_REL_TOL = 2 * E2E_REL_L2


def bench_path() -> Path:
    """The e2e phase's LLaMA-7B Q4_0 file; the gguf phase converts it, and
    then removes it."""
    return ROOT / "build" / "smoke" / "llama7b-q4_0.bin"


def path_launches(name, launches, forwards: int, wide: int,
                  decode: int, spec) -> dict:
    """Exact launches of a B=1 run of `forwards` forwards, `wide` of them
    of more than 32 rows, `decode` of them T=1 (the dense cache's kernel
    once a layer each)."""
    per = 4 * spec.n_layer + 1
    want = {"qmatmul": per * forwards, "qmatmul_swapped": per * (forwards
                                                                  - wide),
            "qmatmul_wide": per * wide,
            "dense_attention": spec.n_layer * decode, "paged_attention": 0}
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    return want


def weights_equal(a, b) -> tuple[int, int]:
    """Every weight of two models' params torch.equal, plane by plane:
    (tensors compared, their bytes)."""
    from dataclasses import fields as dc_fields

    from llm_tpu_torch.ops.packing import QuantTensor

    pairs = [(f.name, getattr(a.layers, f.name), getattr(b.layers, f.name))
             for f in dc_fields(a.layers)]
    pairs += [(f.name, getattr(a, f.name), getattr(b, f.name))
              for f in dc_fields(a) if f.name != "layers"]
    n = nbytes = 0
    for name, x, y in pairs:
        if isinstance(x, QuantTensor):
            if not isinstance(y, QuantTensor) or (
                    x.fmt_name, x.k, x.r, x.splits) != (
                    y.fmt_name, y.k, y.r, y.splits):
                fail(f"gguf: weight {name} differs in kind or shape")
            tensors = list(zip(x.planes(), y.planes()))
        else:
            tensors = [(x, y)]
        for p, q in tensors:
            if (p is None) != (q is None):
                fail(f"gguf: weight {name}: a plane is missing")
            if p is None:
                continue
            if p.dtype != q.dtype or not torch.equal(p, q):
                fail(f"gguf: weight {name} is not equal to the GGML load's")
            n += 1
            nbytes += p.numel() * p.element_size()
    return n, nbytes


def gguf_phase(model, dev, e2e) -> tuple[dict, Path]:
    """The e2e file converted to GGUF v3 by the cli's `gguf-convert` and
    loaded on the card: spec, vocabulary and every plane equal to the GGML
    load's; greedy `infer` of the e2e 64-token prompt gives its 32 tokens,
    and the first prefill and decode logits are bit-equal (the same planes
    through the same kernels)."""
    from dataclasses import asdict

    from llm_tpu_torch import loader
    from llm_tpu_torch.cli import main as cli_main

    src = bench_path()
    dst = src.with_suffix(".gguf")
    out = {"ggml_load_s": e2e["load_s"], "ggml_bytes": e2e["file_bytes"]}
    t0 = time.monotonic()
    try:
        cli_main(["gguf-convert", str(src), str(dst), "-a", "llama"])
    finally:
        src.unlink(missing_ok=True)
    out["convert_s"] = time.monotonic() - t0
    out["gguf_bytes"] = dst.stat().st_size

    t0 = time.monotonic()
    gm = loader.load(dst, "llama",
                     params=loader.ModelParameters(context_size=CTX),
                     device=dev)
    torch.cuda.synchronize()
    out["gguf_load_s"] = time.monotonic() - t0
    if gm.container_type.kind != "gguf":
        fail(f"gguf: loaded a {gm.container_type} container")
    if asdict(gm.spec) != asdict(model.spec):
        fail(f"gguf: spec {gm.spec} differs from the GGML load's")
    vocab = [gm.tokenizer.token(i) for i in range(V)]
    if vocab != [model.tokenizer.token(i) for i in range(V)]:
        fail("gguf: the vocabulary differs from the GGML load's")
    out["weights_equal"], out["weights_bytes_equal"] = weights_equal(
        gm.params, model.params)

    prompt = e2e_prompts()[1]
    zero_launches()
    run = greedy_prompt_run(gm, prompt)
    launches = read_launches()
    out["launches"] = launches
    out["launches_expected"] = path_launches(
        "gguf", launches, 1 + N_PREDICT, 1, N_PREDICT, gm.spec)
    out["run"] = {k: v for k, v in run.items() if k != "new_ids"}
    if run["new_ids"] != e2e["runs"][1]["new_ids"]:
        fail(f"gguf: greedy tokens {run['new_ids']} differ from the GGML "
             f"model's {e2e['runs'][1]['new_ids']}")
    for a, b, what in zip(first_logits(gm, prompt),
                          first_logits(model, prompt),
                          ("prefill", "decode")):
        if not torch.equal(a, b):
            fail(f"gguf: {what} logits not bit-equal to the GGML model's "
                 f"(max |d| {float((a - b).abs().max())})")
    out["first_logits_bit_equal"] = True
    del gm
    gc.collect()
    torch.cuda.empty_cache()
    return out, dst


def perplexity_phase(model, dev) -> dict:
    """`InferenceSession.perplexity` over PPL_CHUNKS windows of seeded
    random ids (bf16 cache): every sub-chunk one forward of 512 rows, its
    4 n_layer + 1 projections and head on qmatmul's wide path (counted
    exactly, no attention kernel: prefill attention is plain torch). The
    first chunk's summed NLL held against the same chunk under
    `plain_versions(bf16=True)` within PPL_REL_TOL; the f32 plain path's
    reported beside. ms a sub-chunk by CUDA events over the whole run,
    scored tokens/s, the sub-chunk's bound, and a profiled sub-chunk."""
    from llm_tpu_torch import session as S
    from llm_tpu_torch.models.forward import nll_step, window_bucket

    spec = model.spec
    ctx = spec.n_ctx
    tokens = np.random.default_rng(7).integers(1, V, PPL_CHUNKS * ctx)
    tokens = tokens.tolist()
    n_sub = PPL_CHUNKS * (ctx // PPL_SUB)
    first = min(512, ctx // 2)
    scored = ctx - 1 - first  # a chunk's scored positions
    out = {"chunks": PPL_CHUNKS, "sub_chunks": n_sub, "context": ctx,
           "scored_tokens": PPL_CHUNKS * scored}

    S.InferenceSession(model).perplexity(tokens[:ctx], lambda i, p: None)
    torch.cuda.synchronize()  # warm-up: the first window's allocations
    sess = S.InferenceSession(model)
    ppl = []
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic()
    start.record()
    sess.perplexity(tokens, lambda i, p: ppl.append(p))
    end.record()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = read_launches()
    out["launches"] = launches
    out["launches_expected"] = path_launches("perplexity", launches, n_sub,
                                             n_sub, 0, spec)
    if len(ppl) != PPL_CHUNKS or not all(map(math.isfinite, ppl)):
        fail(f"perplexity: {ppl}")
    out["perplexity"] = ppl
    out["ms_per_sub_chunk"] = start.elapsed_time(end) / n_sub
    out["wall_s"] = wall_s
    out["scored_tok_s"] = PPL_CHUNKS * scored / wall_s
    out["rows_tok_s"] = PPL_CHUNKS * ctx / wall_s

    nll = math.log(ppl[0]) * scored
    for key, bf16 in (("plain_bf16", True), ("plain_f32", False)):
        plain = []
        with plain_versions(bf16=bf16):
            S.InferenceSession(model).perplexity(
                tokens[:ctx], lambda i, p: plain.append(p))
        ref = math.log(plain[0]) * scored
        out[f"first_chunk_nll_{key}"] = ref
        out[f"first_chunk_rel_err_{key}"] = abs(nll - ref) / abs(ref)
    out["first_chunk_nll"] = nll
    out["tolerance"] = PPL_REL_TOL
    if out["first_chunk_rel_err_plain_bf16"] > PPL_REL_TOL:
        fail(f"perplexity: first chunk's NLL {nll} against the plain "
             f"path's {out['first_chunk_nll_plain_bf16']}")

    # the bound of a sub-chunk: the weights read once, and the products of
    # the projections and of this run's causal attention (each query over
    # the keys at and before it), at the bf16 tensor-core peak
    w_bytes, w_flops_token = weight_traffic(model)
    keys = sum(PPL_SUB * p + PPL_SUB * (PPL_SUB + 1) // 2
               for p in range(0, ctx, PPL_SUB)) / (ctx // PPL_SUB)
    attn_flops = 4.0 * spec.head_dim * spec.n_head * spec.n_layer * keys
    out["bound_ms"], out["bound_by"] = bound_ms(
        w_bytes, w_flops_token * PPL_SUB + attn_flops)
    out["k1_bound_ms"] = bound_ms(w_bytes, w_flops_token * PPL_SUB)[0]

    # one profiled sub-chunk: at half the window (n_past 1024 of 2048)
    p = ctx // 2
    ids = torch.tensor(tokens[p:p + PPL_SUB])
    targets = torch.tensor(tokens[p + 1:p + PPL_SUB + 1])
    valid = torch.ones(PPL_SUB, dtype=torch.bool)

    def step():
        s, _ = nll_step(spec, model.params, ids, targets, valid, p,
                        sess.cache, window_bucket(p + PPL_SUB, ctx))
        float(s)

    out["profile"] = step_profile(step, steps=2)

    # ms of one sub-chunk at each n_past of a window (CUDA events, median
    # of 3): the projections are the same work at each, attention grows
    # with the keys before the chunk
    by_past = {}
    for p in range(0, ctx, PPL_SUB):
        ids = torch.tensor(tokens[p:p + PPL_SUB])
        targets = torch.tensor(tokens[p + 1:p + PPL_SUB + 1])
        times = []
        for _ in range(3):
            start.record()
            nll_step(spec, model.params, ids, targets, valid, p, sess.cache,
                     window_bucket(p + PPL_SUB, ctx))
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        by_past[p] = float(np.median(times))
    out["ms_by_n_past"] = by_past
    return out


def snapshot_phase(model, dev, e2e) -> dict:
    """The e2e 64-token prompt and SNAP_HALF greedy tokens; the session
    written with `snapshot.write_session`, read back onto the card with
    `read_session`, SNAP_HALF more tokens: all of them the e2e phase's
    uninterrupted 32."""
    from llm_tpu_torch import session as S
    from llm_tpu_torch import snapshot
    from llm_tpu_torch.samplers import build_sampler_chain

    prompt = e2e_prompts()[1]
    params = S.InferenceParameters(sampler=build_sampler_chain(
        ["topk:k=1"], bias=[(model.eot_token_id(), float("-inf"))]))
    config = S.InferenceSessionConfig(
        memory_k_type=S.ModelKVMemoryType.Float16,
        memory_v_type=S.ModelKVMemoryType.Float16, n_batch=N_BATCH)
    path = bench_path().with_suffix(".session")
    out = {}
    zero_launches()
    sess = S.InferenceSession(model, config)
    sess.infer(S.InferenceRequest(prompt=prompt, parameters=params,
                                  maximum_token_count=SNAP_HALF),
               rng=np.random.default_rng(0))
    try:
        t0 = time.monotonic()
        snapshot.write_session(sess, path)
        out["write_s"] = time.monotonic() - t0
        out["file_bytes"] = path.stat().st_size
        t0 = time.monotonic()
        back = snapshot.read_session(model, path)
        torch.cuda.synchronize()
        out["read_s"] = time.monotonic() - t0
    finally:
        path.unlink(missing_ok=True)
    out["kv_bytes"] = sum(t.numel() * t.element_size()
                          for t in (back.cache.k, back.cache.v))
    if back.cache.k.device != sess.cache.k.device or not (
            torch.equal(back.cache.k, sess.cache.k)
            and torch.equal(back.cache.v, sess.cache.v)):
        fail("snapshot: the restored cache differs")
    del sess
    back.infer(S.InferenceRequest(prompt=[], parameters=params,
                                  maximum_token_count=SNAP_HALF),
               rng=np.random.default_rng(0))
    launches = read_launches()
    out["launches"] = launches
    out["launches_expected"] = path_launches(
        "snapshot", launches, 1 + 2 * SNAP_HALF, 1, 2 * SNAP_HALF,
        model.spec)
    got = back.tokens[len(prompt):]
    if got != e2e["runs"][1]["new_ids"][:2 * SNAP_HALF]:
        fail(f"snapshot: tokens {got} differ from the uninterrupted run's")
    out["tokens_equal"] = len(got)
    return out


def verify_phase(dev, gguf: Path) -> dict:
    """The port's harness on the GGUF file as `llm-tpu-torch verify -m
    <file>.gguf -a llama` runs it (context 2048, no goldens): the
    real-file cases Hyperparameters, CanSend, Inference (determinism, with
    VERIFY_TOKENS new tokens), Tokens (determinism) and Delete (rewind and
    refeed at the card's tolerance). The bench vocabulary is `<tN>`
    markers, so the inputs are such markers."""
    from llm_tpu_torch import harness

    text = "".join(f"<t{t}>" for t in e2e_prompts()[0])
    config = {"test_cases": [
        {"Inference": {"input": text,
                       "maximum_token_count": VERIFY_TOKENS}},
        {"Tokens": {"input": text}},
        {"Delete": {}},
    ]}
    zero_launches()
    t0 = time.monotonic()
    try:
        report = harness.run_arch("llama", harness.DEFAULT_CONFIG_DIR,
                                  overrides={"model_path": str(gguf)},
                                  config=config, device=dev)
    finally:
        gguf.unlink(missing_ok=True)
    out = {"s": time.monotonic() - t0, "launches": read_launches(),
           "cases": {c.name: {"status": c.status, "s": c.duration_s,
                              "message": c.message[:300]}
                     for c in report.cases}}
    if report.status != "ok":
        fail(f"verify: {report.error[:2000]}")
    want = {"Hyperparameters", "CanSend", "Inference", "Tokens", "Delete"}
    bad = {k: v for k, v in out["cases"].items() if v["status"] != "passed"}
    if set(out["cases"]) != want or bad:
        fail(f"verify: {out['cases']}")
    ls = out["launches"]
    if not (ls["qmatmul"] and ls["dense_attention"]) or \
            ls["paged_attention"]:
        fail(f"verify: kernel launches {ls}")
    return out


# ---------------------------------------------------------------------------
# phase 4c: the six other architectures


# (name, architecture, format, hparams, n_ff, context, prompt lengths, new
# tokens a prompt, the published layer count). Published widths, and
# bench.py's geometry where it has one (its staged configs #1 GPT-2, #3
# StableLM, #4 MPT; MPT with its published vocab, 50,432, where bench.py
# has 32,000). StableLM rotates a quarter of each head (its published
# rotary_pct; bench.py rotates all of it). MPT-7B and the 117M GPT-2 and
# StableLM-3B are whole; GPT-J, BLOOM and Falcon keep 4 of their layers.
ARCH_MODELS = [
    ("mpt7b_q4_k", "mpt", "Q4_K",
     dict(n_vocab=50432, n_embd=4096, n_head=32, n_layer=32,
          alibi_bias_max=8.0), 16384, 8192, (64, 1100), 32, 32),
    ("gpt2_117m_q8_0", "gpt2", "Q8_0",
     dict(n_vocab=50304, n_embd=768, n_head=12, n_layer=12, n_ctx=1024),
     3072, 2048, (64,), 16, 12),
    ("stablelm3b_q5_1", "gptneox", "Q5_1",
     dict(n_vocab=50432, n_embd=2560, n_head=32, n_layer=32, n_rot=20),
     10240, 2048, (64,), 16, 32),
    ("gptj6b_q4_0", "gptj", "Q4_0",
     dict(n_vocab=50400, n_embd=4096, n_head=16, n_layer=4, n_rot=64),
     16384, 2048, (64,), 16, 28),
    ("bloom7b1_q4_0", "bloom", "Q4_0",
     dict(n_vocab=250880, n_embd=4096, n_head=32, n_layer=4), 16384, 2048,
     (64,), 16, 30),
    ("falcon7b_q4_0", "falcon", "Q4_0",
     dict(n_vocab=65024, n_embd=4544, n_head=71, n_head_kv=1, n_layer=4),
     18176, 2048, (64,), 16, 32),
]
ARCH_BLOCK = 16  # --decode-steps of the timed device-sampling blocks
# MPT's paged cell (bench.py:1019-1075): 2 streams at n_past 7680, page 256
MPT_CELL_STREAMS, MPT_CELL_PAST = 2, 7680
ENGINE_PROMPT_LENS = (16, 100, 300, 600)  # the engines' 4 greedy prompts


def top1_held(name, got, ref) -> dict:
    """Top-1 of each row of `got` equal to `ref`'s, except at a near-tie:
    a row whose top-2 margin in `ref` is within E2E_REL_L2 of its largest
    |logit| may pick the other of the two (each product rounds x and W to
    bf16). Fails the run on any other row."""
    top2 = ref.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= E2E_REL_L2 * ref.abs().amax(-1)
    differs = got.argmax(-1) != ref.argmax(-1)
    if bool((differs & ~tie).any()):
        fail(f"{name}: top-1 differs from the plain path's at rows "
             f"{torch.nonzero(differs & ~tie).flatten().tolist()}")
    return {"rows": int(differs.numel()), "differ": int(differs.sum()),
            "near_ties": int(tie.sum())}


@contextlib.contextmanager
def layer_trace(outs: list, inputs: Optional[list] = None):
    """Record each decoder layer's output h into `outs`, in call order;
    with `inputs` (another run's recorded layer inputs), run each layer on
    that input in place of its own (teacher forcing: a layer's difference
    is then its own, not the layers' before it)."""
    from llm_tpu_torch.models import forward as fwd

    inner = fwd._layer_batched
    seen = []

    def wrapped(spec, h, *a, **k):
        if inputs is not None:
            h = inputs[len(seen)]
        seen.append(h.clone())
        out = inner(spec, h, *a, **k)
        outs.append(out[0].clone())
        return out

    fwd._layer_batched = wrapped
    try:
        yield seen
    finally:
        fwd._layer_batched = inner


def arch_logits(name, model) -> dict:
    """The first prefill (64 tokens) and decode logits of the kernel path
    against the plain path on the same card, whose qmatmul rounds x and W
    to bf16 as the kernel does, each decoder layer run on the plain run's
    input for that layer (`layer_trace`): every layer's output and the
    logits within E2E_REL_L2 relative L2, top-1 equal (`top1_held`).

    The layers are forced because these random models are chaotic: their
    attention, over random weights of large magnitude, is nearly a hard
    max, and a change in the 7th digit of a score may pick another key.
    Reported beside, not held: the free-running distances of the kernel
    path to the bf16 and the f32 plain path, and the model's own
    sensitivity, the distance between two free-running bf16 plain runs
    that sum the same products in another order (`halves`)."""
    ids = np.random.default_rng(11).integers(1, model.spec.n_vocab,
                                             64).tolist()
    plain_h, kern_h = [], []
    with plain_versions(bf16=True), layer_trace(plain_h) as plain_in:
        pre_p, dec_p = first_logits(model, ids)
    with layer_trace(kern_h, plain_in):
        pre_k, dec_k = first_logits(model, ids)
    layer_l2 = [float((k - p).norm() / p.norm())
                for k, p in zip(kern_h, plain_h)]
    out = {"layers": len(layer_l2), "layer_rel_l2_max": max(layer_l2),
           "layer_rel_l2": layer_l2}
    if max(layer_l2) > E2E_REL_L2:
        fail(f"{name}: a layer's output differs from the plain layer's on "
             f"the same input: rel L2 {max(layer_l2):.3g} > {E2E_REL_L2}")
    free_k = first_logits(model, ids)
    with plain_versions():
        free_f = first_logits(model, ids)
    with plain_versions(bf16=True, halves=True):
        free_h = first_logits(model, ids)
    for i, part in enumerate(("prefill", "decode")):
        got, ref = (pre_k, dec_k)[i], (pre_p, dec_p)[i]
        out[part] = {**compare_logits(f"{name} {part}", got, ref),
                     **top1_held(f"{name} {part}", got, ref)}
        for key, a, b in (("free_vs_bf16_plain", free_k[i], ref),
                          ("free_vs_f32_plain", free_k[i], free_f[i]),
                          ("plain_halves_vs_bf16_plain", free_h[i], ref)):
            out[part][key] = {
                "rel_l2": float((a - b).norm() / b.norm()),
                "top1_agree": float((a.argmax(-1) == b.argmax(-1))
                                    .float().mean())}
    return out


def arch_infer(name, model, prompts, n_new) -> dict:
    """(a) greedy host-sampled `infer` on each prompt, with the launch
    counters zeroed just before and read just after: per forward the
    model's `step_launches`, prompt chunks of 512 rows on qmatmul's wide
    path and decode steps on its swapped path."""
    greedy_prompt_run(model, prompts[0][:4], 2)  # loads the libraries
    zero_launches()
    runs = [greedy_prompt_run(model, p, n_new) for p in prompts]
    launches = read_launches()
    one = step_launches(model.spec)
    steps = sum(math.ceil(len(p) / N_BATCH) + n_new for p in prompts)
    decode = sum(n_new + (len(p) % N_BATCH == 1) for p in prompts)
    want = {"qmatmul": one["qmatmul"] * steps,
            "qmatmul_swapped": one["qmatmul"] * decode,
            "qmatmul_wide": one["qmatmul"] * (steps - decode),
            "dense_attention": one["dense_attention"] * decode,
            "paged_attention": 0}
    if launches != want:
        fail(f"{name} infer: kernel launches {launches}, expected {want}")
    return {"runs": runs, "launches": launches}


def greedy_tokens_held(name, model, prompt, got, want) -> Optional[dict]:
    """Device-sampled greedy tokens `got` against the host-sampled `want`
    after `prompt`: equal, or equal up to a step where the host chain's
    logits (EoT banned, repetition 1.3 over 64, read after prompt + the
    common tokens) put both tokens within E2E_REL_L2 of their largest
    |logit| from the top. The host chain's `topk:k=1` keeps every token
    tied at the top and samples among them; the device's greedy takes the
    first (as in the reference). Fails the run on any other difference;
    returns the difference, or None."""
    from llm_tpu_torch.samplers import build_sampler_chain

    if got == want:
        return None
    j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    if j == min(len(got), len(want)):
        fail(f"{name}: {len(got)} device tokens against {len(want)}")
    sess = ds_session(model)
    tokens = list(prompt) + list(want[:j])
    sess.feed_prompt(tokens)
    x = np.array(sess.last_logits, np.float32)
    del sess
    chain = build_sampler_chain(
        ["topk:k=1"], bias=[(model.eot_token_id(), float("-inf"))])
    for t in chain.transforms:  # the ban and the penalty, no truncation
        if type(t).__name__ in ("FlatBias", "Repetition"):
            x = t.apply(x, tokens, None)
    top = float(x.max())
    d = {"step": j, "host": int(want[j]), "device": int(got[j]),
         "host_gap": top - float(x[want[j]]),
         "device_gap": top - float(x[got[j]]),
         "tolerance": E2E_REL_L2 * float(np.abs(x[np.isfinite(x)]).max())}
    emit({"archs_device_token_differs": {name: d}})
    if max(d["host_gap"], d["device_gap"]) > d["tolerance"]:
        fail(f"{name}: device greedy tokens {got} != host-sampled {want} "
             f"at step {j}, not a tie: {d}")
    return d


def arch_device_sampling(name, model, prompts, runs, n_new) -> dict:
    """(c) `infer_device` greedy (the host chain's repetition slot and the
    EoT ban as device sampler) gives the host-sampled tokens, but after a
    tie (`greedy_tokens_held`), each capture counting one forward's
    launches; then decode ms a token of blocks of
    ARCH_BLOCK (CUDA events, graphs captured first), the busy share of a
    profiled block, and host-sampled ms a step in the same run."""
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.session import InferenceParameters

    spec = model.spec
    greedy = ds_samplers(model)["greedy"]
    graphs, ties = [], []
    for prompt, host in zip(prompts, runs):
        sess = ds_session(model)
        sess.infer_device(prompt, n_new, sampler=greedy, n_steps=DS_STEPS,
                          halt_on_eot=False)
        new = sess.tokens[len(prompt):]
        graphs += graph_records(sess)
        del sess
        tie = greedy_tokens_held(f"{name} device sampling, prompt of "
                                 f"{len(prompt)}", model, prompt, new,
                                 host["new_ids"])
        if tie is not None:
            ties.append(tie)
    launches_held(f"{name} greedy runs", graphs, spec)
    sess = ds_session(model)
    sess.infer_device(prompts[0], ARCH_BLOCK, sampler=greedy,
                      n_steps=ARCH_BLOCK, halt_on_eot=False)  # captures

    def block():
        sess.infer_device([], ARCH_BLOCK, sampler=greedy, n_steps=ARCH_BLOCK,
                          halt_on_eot=False)

    dev_ms, wall_ms = events_ms(block)
    prof = step_profile(block, steps=1)
    graphs += graph_records(sess)
    launches_held(f"{name} timed blocks", graphs, spec)
    del sess
    host = ds_session(model)
    host.feed_prompt(prompts[0])
    chain = build_sampler_chain(["topk:k=1"],
                                bias=[(model.eot_token_id(), float("-inf"))])
    params = InferenceParameters(sampler=chain)
    rng = np.random.default_rng(0)
    host.infer_next_token(rng, params)  # warm
    host_ms, host_wall = events_ms(lambda: [host.infer_next_token(rng, params)
                                            for _ in range(ARCH_BLOCK)])
    del host
    wbytes, _ = weight_traffic(model)
    busy = prof["device_busy_share"]
    return {
        "ms_per_token": dev_ms / ARCH_BLOCK,
        "wall_ms_per_token": wall_ms / ARCH_BLOCK,
        "bound_ms_per_token": 1e3 * wbytes / HBM_BYTES_PER_S,
        "bound_by": "bytes", "weight_bytes_read": wbytes,
        "host_ms_per_step": host_ms / ARCH_BLOCK,
        "host_wall_ms_per_step": host_wall / ARCH_BLOCK,
        "device_busy_share": busy,
        "busy_share_how": (
            "union of the kernel intervals torch.profiler recorded over a "
            f"{ARCH_BLOCK}-token block, over its untraced wall time"
            if busy is not None else
            "not measured: torch.profiler recorded no kernel of the replays"),
        "device_ms_per_token": (prof["device_ms_per_step"] / ARCH_BLOCK
                                if busy is not None else None),
        "top_device": prof["top_device"],
        "tokens_equal": len(prompts) - len(ties), "ties": ties,
        "graphs": graphs,
    }


def arch_qmatmul(name, model, rng, dev, timer) -> dict:
    """K1 at M=1 on the model's own weights (layer 0 of each projection,
    and the head), held against its plain version and timed; the sums of
    one decode token's launches (n_layer x the layer's, + the head)."""
    p = model.params
    head = p.lm_head if p.lm_head is not None else p.wte
    L = model.spec.n_layer
    ws = [(f, getattr(p.layers, f).layer(0), L)
          for f in ("w_qkv", "wo", "w_gate_up", "w_up", "w_down")
          if getattr(p.layers, f) is not None] + [("head", head, 1)]
    recs = []
    for f, w, n in ws:
        r = check_qmatmul(f"{name}:{f}", w, 1, rng, dev, timer, True)
        r["per_token"] = n
        if not r["ok"]:
            fail(f"{name}: qmatmul out of tolerance: {r}")
        recs.append(r)
    token = {k: sum(r[k] * r["per_token"] for r in recs)
             for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    token["launches"] = sum(r["per_token"] for r in recs)
    return {"cases": recs, "per_token": token}


def texts_held(name, got, ref, model, prompts, kv) -> list:
    """Texts `got` against `ref` (one a prompt): a token may differ only
    where the top-2 margin of the penalized logits is within E2E_REL_L2
    of their size (`token_margin`, over a `kv` pool), else the run fails.
    Returns the differences."""
    diffs = []
    for i, (a, b) in enumerate(zip(got, ref)):
        a_ids = [int(x) for x in TOKEN.findall(a)]
        b_ids = [int(x) for x in TOKEN.findall(b)]
        if a_ids == b_ids:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a_ids, b_ids)) if x != y)
        d = {"run": name, "request": i, "step": j,
             **token_margin(model, prompts[i], b_ids[:j], kv)}
        emit({"archs_token_differs": d})
        diffs.append(d)
        if d["margin"] > d["tolerance"]:
            fail(f"{name}: request {i} differs at step {j}, top-2 margin "
                 f"{d['margin']:.4g} > {d['tolerance']:.4g}")
    return diffs


def arch_engines(name, model, dev) -> dict:
    """(e) A paged engine (4 slots, page 256, int8 pool, prefix cache) and
    a dense bf16 engine answer the same 4 greedy prompts, host-stepped and
    in blocks of 16: each engine's block texts equal its host-stepped
    ones; the paged texts equal those of a dense engine over an int8 cache
    (the same row codes). Against the dense bf16 texts, whose attention
    reads other rows than an int8 pool's, only the equal texts are counted.
    A token may differ only at a near-tie (`texts_held`). The host-stepped
    runs count their launches (`check_engine_launches`), each block
    capture one forward's."""
    from llm_tpu_torch import paged as paged_mod
    from llm_tpu_torch import serve as serve_mod
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.serve import Engine, GenerationRequest

    eot = model.eot_token_id()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, model.spec.n_vocab, n).tolist()
               for n in ENGINE_PROMPT_LENS]

    def paged():
        return PagedEngine(model, max_streams=4, page_size=SERVE_PAGE,
                           kv_dtype="int8", n_batch=64, prefix_cache=True)

    def dense(kv):
        return lambda: Engine(model, max_streams=4, kv_dtype=kv, n_batch=64)

    runs = [("paged_int8", paged, paged_mod, "paged_forward_batched",
             "paged_attention", n) for n in (1, MS_STEPS)]
    runs += [("dense_bf16", dense(torch.bfloat16), serve_mod,
              "forward_batched", "dense_attention", n)
             for n in (1, MS_STEPS)]
    runs.append(("dense_int8", dense("int8"), serve_mod, "forward_batched",
                 "dense_attention", 1))
    out, texts = {}, {}
    for kind, make, module, fwd, attention, n_steps in runs:
        engine = make()
        reqs = [GenerationRequest(
            prompt=p, max_tokens=SERVE_NEW,
            sampler=build_sampler_chain(["topk:k=1"],
                                        bias=[(eot, float("-inf"))]),
            device_sampler=greedy_block_sampler(model)) for p in prompts]
        with counted_forwards(module, fwd) as counts:
            zero_launches()
            t0 = time.monotonic()
            got = list(engine.generate_all(reqs, n_steps=n_steps).values())
            wall = time.monotonic() - t0
            launches = read_launches()
        if any(t.count("<t") != SERVE_NEW for t in got):
            fail(f"{name} {kind}: a request did not yield {SERVE_NEW} "
                 "tokens")
        rec = {"wall_s": wall, "launches": launches}
        if n_steps == 1:
            check_engine_launches(f"{name} {kind}", launches, counts,
                                  attention, model.spec)
        else:
            graphs = (engine.pool.graphs if kind == "paged_int8"
                      else engine.cache.graphs)
            recs = graph_stats(graphs)
            ms_launches_held(f"{name} {kind} blocks", recs, attention,
                             model.spec)
            rec.update(blocks=engine.multi_blocks,
                       block_steps=engine.multi_block_steps,
                       fallbacks=engine.multi_fallbacks, graphs=recs)
            if not engine.multi_blocks or any(
                    engine.multi_fallbacks.values()):
                fail(f"{name} {kind} blocks: {engine.multi_blocks} blocks, "
                     f"fallbacks {engine.multi_fallbacks}")
        key = f"{kind}_steps{n_steps}"
        out[key] = rec
        texts[key] = got
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    blocks = f"_steps{MS_STEPS}"
    out["differs"] = [
        *texts_held(f"{name} paged int8 blocks", texts["paged_int8" + blocks],
                    texts["paged_int8_steps1"], model, prompts, "int8"),
        *texts_held(f"{name} dense bf16 blocks", texts["dense_bf16" + blocks],
                    texts["dense_bf16_steps1"], model, prompts,
                    torch.bfloat16),
        *texts_held(f"{name} paged int8 vs dense int8",
                    texts["paged_int8_steps1"], texts["dense_int8_steps1"],
                    model, prompts, "int8")]
    out["texts_equal"] = {
        "paged_int8_blocks_vs_steps": texts["paged_int8" + blocks]
        == texts["paged_int8_steps1"],
        "dense_bf16_blocks_vs_steps": texts["dense_bf16" + blocks]
        == texts["dense_bf16_steps1"],
        "paged_int8_vs_dense_int8": texts["paged_int8_steps1"]
        == texts["dense_int8_steps1"],
        "paged_int8_vs_dense_bf16_equal_texts": sum(
            a == b for a, b in zip(texts["paged_int8_steps1"],
                                   texts["dense_bf16_steps1"])),
    }
    out["prompt_tokens"] = list(ENGINE_PROMPT_LENS)
    return out


def arch_model(entry, dev, timer) -> dict:
    """Write one model of ARCH_MODELS with `make_bench_file` under
    build/smoke/, load it on the card (the file is removed afterwards) and
    drive (a), (b), (c) and K1 on its weights; MPT also (d) and (e)."""
    from llm_tpu_torch import loader
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.testing import make_bench_file

    name, arch, fmt, hp, n_ff, ctx, lens, n_new, published = entry
    out = {"arch": arch, "format": fmt, "n_ff": n_ff, "context": ctx,
           "layers_published": published, **hp}
    smoke_dir = ROOT / "build" / "smoke"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    path = smoke_dir / f"{name}.bin"
    t_start = time.monotonic()
    try:
        t0 = time.monotonic()
        make_bench_file(arch, path, GgmlType[fmt], seed=0, n_ff=n_ff, **hp)
        out["write_s"] = time.monotonic() - t0
        out["file_bytes"] = path.stat().st_size
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.monotonic()
        model = loader.load(path, arch,
                            params=loader.ModelParameters(context_size=ctx),
                            device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t0
    finally:
        path.unlink(missing_ok=True)
    spec = model.spec
    out["weights_bytes"] = torch.cuda.memory_allocated(dev) - base
    out["n_ctx"] = spec.n_ctx  # GPT-2: capped at its 1024 positions
    want_ctx = min(ctx, hp["n_ctx"]) if spec.learned_pos else ctx
    if (spec.n_embd, spec.n_head, spec.n_layer, spec.n_vocab, spec.n_ctx) != \
            (hp["n_embd"], hp["n_head"], hp["n_layer"], hp["n_vocab"],
             want_ctx):
        fail(f"{name}: loaded spec {spec}")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, spec.n_vocab, n).tolist() for n in lens]
    out["infer"] = arch_infer(name, model, prompts, n_new)
    out["qmatmul"] = arch_qmatmul(name, model, rng, dev, timer)
    out["logits"] = arch_logits(name, model)
    out["device_sampling"] = arch_device_sampling(
        name, model, prompts, out["infer"]["runs"], n_new)
    if arch == "mpt":
        # (d) the paged loop at the bench's cell, timed against its bound
        # (the weights once plus the K/V rows and scales below n_past)
        out["paged_cell"] = paged_loop_case(
            model, dev, MPT_CELL_STREAMS, [MPT_CELL_PAST] * MPT_CELL_STREAMS,
            "mpt paged int8 B=2 at 7680")
        out["engines"] = arch_engines(name, model, dev)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_start
    return out


def archs_launches(models) -> dict:
    """Each kernel's launches over the phase's main-path runs: the counted
    launches of the host-stepped runs (`infer`, the engines' steps, their
    prefills), and each graph's capture count times its replays."""
    names = ("qmatmul", "dense_attention", "paged_attention")
    total = dict.fromkeys(names, 0)
    for m in models.values():
        counted = [m["infer"]["launches"]]
        graphs = m["device_sampling"]["graphs"] + m.get(
            "paged_cell", {}).get("graphs", [])
        for rec in m.get("engines", {}).values():
            if isinstance(rec, dict) and "launches" in rec:
                counted.append(rec["launches"])
                graphs = graphs + rec.get("graphs", [])
        for k in names:
            total[k] += sum(c[k] for c in counted) + sum(
                g["launches_per_replay"][k] * g["replays"] for g in graphs)
    return total


# the kernels at these models' shapes that no model run above times: K2 at
# Falcon-7B's decode (B=1, one kv head of 71 query heads, D 64, W 512, bf16
# cache, full window) and K4 at MPT's paged cell (int8 pool, ALiBi)
ARCH_DENSE_CASE = ("falcon7b", "bf16", 512, (512,), 1, 71, False, True, 64)
ARCH_PAGED_CASE = ("mpt7b_8k", "int8", SERVE_PAGE, MPT_CELL_STREAMS,
                   ("all", MPT_CELL_PAST), 32, 1, True)


def archs_phase(dev, timer) -> dict:
    out = {"models": {}}
    for entry in ARCH_MODELS:
        out["models"][entry[0]] = arch_model(entry, dev, timer)
    rng = np.random.default_rng(13)
    name, kv, W, n_past, hkv, rep, alibi, timed, d = ARCH_DENSE_CASE
    k2 = check_attention(name, kv, W, list(n_past), hkv, rep, alibi, rng,
                         dev, timer, timed, d=d)
    k4 = check_paged(ARCH_PAGED_CASE, rng, dev, timer)
    torch.cuda.empty_cache()
    for r in (k2, k4):
        if not r["ok"]:
            fail(f"archs: attention out of tolerance: {r}")
    out["kernel_cases"] = {"dense_attention": k2, "paged_attention": k4}
    out["launches"] = archs_launches(out["models"])
    out["summary"] = {
        name: {"load_s": m["load_s"], "weights_bytes": m["weights_bytes"],
               "peak_bytes": m["peak_bytes"], "n_ctx": m["n_ctx"],
               **{k: m["device_sampling"][k] for k in (
                   "ms_per_token", "bound_ms_per_token", "host_ms_per_step",
                   "device_busy_share", "device_ms_per_token")},
               "k1_ms_per_token": m["qmatmul"]["per_token"],
               "logits_rel_l2": [m["logits"]["prefill"]["rel_l2"],
                                 m["logits"]["decode"]["rel_l2"]],
               "layer_rel_l2_max": m["logits"]["layer_rel_l2_max"],
               "free_logits_rel_l2_vs_bf16_plain": [
                   m["logits"][p]["free_vs_bf16_plain"]["rel_l2"]
                   for p in ("prefill", "decode")],
               "free_logits_rel_l2_vs_f32_plain": [
                   m["logits"][p]["free_vs_f32_plain"]["rel_l2"]
                   for p in ("prefill", "decode")],
               "plain_halves_rel_l2_vs_bf16_plain": [
                   m["logits"][p]["plain_halves_vs_bf16_plain"]["rel_l2"]
                   for p in ("prefill", "decode")],
               "seconds": m["seconds"]}
        for name, m in out["models"].items()}
    mpt = out["models"]["mpt7b_q4_k"]
    cell = mpt["paged_cell"]
    out["summary"]["mpt7b_q4_k"].update(
        paged_cell={k: cell[k] for k in (
            "ms_per_step", "tok_s", "bound_ms_per_step", "device_busy_share",
            "device_ms_per_step")},
        engines_texts_equal=mpt["engines"]["texts_equal"])
    out["summary"]["kernels"] = {
        "dense_attention_falcon7b": {k: k2[k] for k in (
            "ms", "bound_ms", "plain_ms", "library_ms")},
        "paged_attention_mpt_cell": {k: k4[k] for k in (
            "ms", "bound_ms", "plain_ms", "library_ms")}}
    emit({"archs_summary": out["summary"]})
    return out


# ---------------------------------------------------------------------------
# phase 5: the chip probes P1-P3


# Probe kernels against their plain versions on the same card, by rule:
# - exact: stream and unpack are wrapping integer sums, held exactly;
# - dequant: sums bf16 weights over K in another order: 1e-5 of the sum of
#   |w| a column (padding columns exactly);
# - mode: a mode's kernel and plain version compute the same products and
#   differ in summation order only: 1e-5 of |y| plus 1e-5 of max|y|
#   (nounpack's weights reach ~1e6 and its sums cancel);
# - qmatmul: K1 (P2's full, P1's plane) as check_qmatmul holds it;
# - equal: K3 at a P1 tiling bit-equal to K1 over the planes.
PROBE_TOL = 1e-5


def held(probe, case, layout, got, ref, rule, w, x=None, **extra) -> dict:
    """A probe variant's kernel result `got` against `ref` (its plain
    version, or K1's kernel result for rule "equal") by `rule`."""
    torch.cuda.synchronize()
    rec = {"probe": probe, "case": case, "layout": layout,
           "fmt": w.fmt_name, "K": w.k, "R": w.r, **extra}
    if rule == "qmatmul":
        return {**rec, **qmatmul_held(got, x, w)}
    if rule == "exact":
        ok = bool(torch.equal(got, ref))
        e = float(((got.long() - ref.long()) % (1 << 32)).max())
    elif rule == "equal":
        ok, e = bool(torch.equal(got, ref)), float((got - ref).abs().max())
    elif rule == "dequant":
        w_abs = dequant_any(w).abs().sum(dim=-2)  # [R]
        err = (got[: w.r] - ref[: w.r]).abs()
        ok = bool((err <= PROBE_TOL * w_abs).all()) and bool(
            torch.equal(got[w.r:], ref[w.r:]))
        e = float((got - ref).abs().max())
    else:  # mode
        err = (got - ref).abs()
        ok = bool((err <= PROBE_TOL * (ref.abs() + ref.abs().max())).all())
        e = float(err.max())
        rec["max_rel_err"] = e / float(ref.abs().max())
    return {**rec, "ok": ok, "max_abs_err": e}


def stage_rule(stage: str) -> str:
    return "dequant" if stage == "dequant" else "exact"


def probe_checks(dev) -> list[dict]:
    """Every P2 stage, P3 mode and P1 variant against its plain version at
    K=1024, R=512, layer 1 of a 2-layer stack, over Q4_0, Q8_0 and Q6_K
    where the variant takes the format."""
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops import packing
    from llm_tpu_torch.ops import qmatmul as qm
    from llm_tpu_torch.ops import qmatmul_probe as qp
    from llm_tpu_torch.probes import coalesced as p1
    from llm_tpu_torch.probes import dequant_variants as p3

    rng = np.random.default_rng(9)
    K, R, M = 1024, 512, 8
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(dev)
    recs = []

    def stacked(t, r_multiple=128):
        ws = [random_weight(t, K, R, rng, dev) for _ in range(2)]
        if r_multiple != 128:
            ws = [packing.pad_r_qt(w, r_multiple) for w in ws]
        return packing.QuantTensor(ws[0].fmt_name, K, R, *(
            None if getattr(ws[0], n) is None
            else torch.stack([getattr(q, n) for q in ws])
            for n in ("lo", "hi", "scale", "bias")))

    def stage_rec(probe, case, layout, w, stage):
        return held(probe, case, layout, qp.stage_run(w, stage, M),
                    qp.stage_plain(w, stage), stage_rule(stage), w)

    # P2 stages (and P1/P3's stream) over planes and coalesced buffers
    for t in (GgmlType.Q4_0, GgmlType.Q8_0, GgmlType.Q6_K):
        st = stacked(t)
        sc = packing.coalesce_qt(st, 512, 128)  # 2 k-tiles, 4 r-tiles
        for stage in qp.STAGES:
            recs.append(stage_rec("P2", stage, "planes", st.layer(1), stage))
            recs.append(stage_rec("P2", stage, "coalesced", sc.layer(1),
                                  stage))
    # P3 modes over a coalesced q4_0, whole K x 512 lanes
    st = stacked(GgmlType.Q4_0, 1024)
    qtc = packing.coalesce_qt(st, st.k_padded, 512).layer(1)
    for mode in p3.MODES:
        if mode == "stream":
            recs.append(stage_rec("P3", mode, "coalesced", qtc, "stream"))
            continue
        recs.append(held("P3", mode, "coalesced", qp.mode_run(x, qtc, mode),
                         qp.mode_plain(x, qtc, mode), "mode", qtc))
    # P1: K3 at each tiling bit-equal to K1; each buffer's stream stage
    weights = p1.build(K, R, 10, dev)
    plane = qm.qmatmul(x, weights["plane"])
    for name, w in weights.items():
        if name == "plane":
            continue
        recs.append(held("P1", name, "coalesced", qm.qmatmul(x, w), plane,
                         "equal", w, tiles=[w.tile_k, w.tile_r]))
        recs.append(stage_rec("P1", f"{name}_stream", "coalesced", w,
                              "stream"))
    return recs


def probe_checks_7b(dev) -> list[dict]:
    """Every probe variant's kernel against its plain version on one layer
    at the shape and M its probe runs it: P2 over q4_0 4096 x 4096 planes
    at M = 8 and 1; P3 over 4096 x 11008 coalesced whole K x 512 lanes; P1
    at up and down, every tiling."""
    from llm_tpu_torch.probes import coalesced as p1
    from llm_tpu_torch.probes import common
    from llm_tpu_torch.probes import dequant_variants as p3
    from llm_tpu_torch.probes import kernel_decompose as p2

    def x_of(M, K):  # the probes' own x
        return torch.from_numpy(np.random.default_rng(1).standard_normal(
            (M, K)).astype(np.float32)).to(dev)

    recs = []
    w = common.random_q4_0(p2.K, p2.R, 0, dev)
    for M in (8, 1):
        x = x_of(M, w.k)
        for v in p2.VARIANTS:
            rule = "qmatmul" if v == "full" else stage_rule(v)
            recs.append(held("P2", v, "planes", p2.variant_launch(v, x, w)(),
                             p2.variant_plain(v, x, w), rule, w, x, M=M,
                             shape="7b"))
    del w
    qtc = p3.build(p3.K, p3.R, 0, dev)
    x = x_of(p3.M, qtc.k)
    for m in p3.MODES:
        recs.append(held("P3", m, "coalesced", p3.mode_launch(m, x, qtc)(),
                         p3.mode_plain(m, x, qtc),
                         "exact" if m == "stream" else "mode", qtc, M=p3.M,
                         shape="7b"))
    del qtc
    for shape in p1.SHAPES:
        weights = p1.build(*p1.SHAPES[shape], 0, dev)
        x = x_of(p1.M, weights["plane"].k)
        plane = p1.variant_launch("plane", x, weights["plane"])()
        recs.append(held("P1", "plane", "planes", plane, None, "qmatmul",
                         weights["plane"], x, M=p1.M, shape=shape))
        for n in p1.all_variants():
            if n in ("plane", "dense") or \
                    n.removesuffix("_stream") not in weights:
                continue
            w = p1.variant_weight(n, weights)
            got = p1.variant_launch(n, x, w)()
            if n.endswith("_stream"):
                rec = held("P1", n, "coalesced", got,
                           p1.variant_plain(n, x, w), "exact", w)
            else:
                rec = held("P1", n, "coalesced", got, plane, "equal", w)
            recs.append({**rec, "M": p1.M, "shape": shape,
                         "tiles": [w.tile_k, w.tile_r]})
        del weights
    torch.cuda.empty_cache()
    return recs


def probe_phase(dev) -> dict:
    """The three probes at their 7B geometry, few rounds, each with the
    counters zeroed just before and read just after its run, which must
    count every launch the probe made; their tables are printed."""
    from llm_tpu_torch.ops import qmatmul as qm
    from llm_tpu_torch.ops import qmatmul_probe as qp
    from llm_tpu_torch.probes import coalesced as p1
    from llm_tpu_torch.probes import dequant_variants as p3
    from llm_tpu_torch.probes import kernel_decompose as p2

    out = {}
    runs = {
        "P2_M8": lambda: p2.run(dev, M=8, rounds=3),
        "P2_M1": lambda: p2.run(dev, M=1, rounds=3),
        "P3": lambda: p3.run(dev, modes=p3.MODES, rounds=3),
        "P1_up": lambda: p1.run(dev, "up", p1.all_variants(), rounds=3),
        "P1_down": lambda: p1.run(dev, "down", p1.all_variants(), rounds=2),
    }
    for key, run in runs.items():
        zero_launches()
        res = run()
        got = {"probe": qp.LAUNCHES, "qmatmul": qm.LAUNCHES}
        rows = res.get("variants") or res.get("modes")
        want = sum(d.get("launches", 0) for d in rows.values())
        if got["probe"] + got["qmatmul"] != want or any(
                d.get("launches", 1) == 0 for n, d in rows.items()
                if n != "dense"):
            fail(f"{key}: probe launches {got}, expected {want} in all")
        res["launches_counted"] = got
        (p1 if key.startswith("P1") else p2 if key.startswith("P2")
         else p3).report(res)
        out[key] = res
        torch.cuda.empty_cache()
    return out


def probe_entries(probes, checks, dev, timer) -> list[dict]:
    """The kernel line's entries of P1-P3. Each reports its headline
    variant (P1: the stream pass over coalesce_tiles' own tiling, the
    kernel `make_stream_chain` built; P2: the stream stage at M=8; P3:
    base): device time a launch at 7B from the probe's run, the bound of
    that launch, and the plain version's and one torch.matmul's time on
    one layer of the same weight (bf16, the same [M, K] x [K, R] shape).
    `max_abs_err` is the headline variant's largest over its checks (small
    and 7B shapes); `checks` counts all of the probe's."""
    from llm_tpu_torch.ops import qmatmul_probe as qp
    from llm_tpu_torch.probes import coalesced as p1
    from llm_tpu_torch.probes import common
    from llm_tpu_torch.probes import dequant_variants as p3

    M = 8

    def x_of(K):
        return torch.from_numpy(np.random.default_rng(11).standard_normal(
            (M, K)).astype(np.float32)).to(dev)

    def matmul(K, R):
        xb = x_of(K).bfloat16()
        wb = torch.randn((K, R), device=dev).bfloat16()
        return lambda: torch.matmul(xb, wb)

    out = []
    specs = []
    w1 = p1.build(*p1.SHAPES["up"], 0, dev)["coalK"]
    specs.append(("probe_coalesced", "P1", probes["P1_up"], "coalK_stream",
                  "scripts/probe_coalesced.py:137",
                  w1.buf.numel() * 4 + w1.rp * 4, 0.0,
                  lambda: qp.stage_plain(w1, "stream"),
                  matmul(w1.k, w1.r)))
    w2 = common.random_q4_0(4096, 4096, 0, dev)
    specs.append(("probe_kernel_decompose", "P2", probes["P2_M8"], "stream",
                  "scripts/probe_kernel_decompose.py:108",
                  (w2.lo.numel() + w2.scale.numel()) * 4 + w2.r_padded * 4,
                  0.0, lambda: qp.stage_plain(w2, "stream"),
                  matmul(w2.k, w2.r)))
    w3 = p3.build(p3.K, p3.R, 0, dev)
    x3 = x_of(w3.k)
    specs.append(("probe_dequant_variants", "P3", probes["P3"], "base",
                  "scripts/probe_dequant_variants.py:221",
                  w3.buf.numel() * 4 + M * w3.k * 2 + M * w3.r * 4,
                  2.0 * M * w3.k * w3.r,
                  lambda: qp.mode_plain(x3, w3, "base"),
                  matmul(w3.k, w3.r)))
    for name, tag, res, variant, rep, n_bytes, flops, plain, lib in specs:
        rows = res.get("variants") or res.get("modes")
        b, by = bound_ms(n_bytes, flops)
        out.append({
            "name": name, "route": "cuda",
            "source": "llm_tpu_torch/csrc/qmatmul_probe.cu",
            "replaces": rep,
            "launches": sum(res["launches_counted"].values()),
            "max_abs_err": max(r["max_abs_err"] for r in checks
                               if r["probe"] == tag and r["case"] == variant),
            "max_rel_err": max(r.get("max_rel_err", 0.0) for r in checks
                               if r["probe"] == tag and r["case"] == variant),
            "checks": sum(r["probe"] == tag for r in checks),
            "ms": rows[variant]["us"] / 1e3, "plain_ms": timer.ms(plain, 3),
            "bound_ms": b, "bound_by": by, "library_ms": timer.ms(lib, 3),
            "variant": variant,
            "per": f"one launch of {variant} at the probe's 7B shape "
                   f"(M={res['M']}, L={res['L']}; device time of a chain "
                   "after a spin)",
            "variants_us": {n: d["us"] for n, d in rows.items()},
            "variants_kernel_us": {n: d["kernel_us"]
                                   for n, d in rows.items()},
            "busy_share": {n: d["busy_share"] for n, d in rows.items()},
        })
    return out


# ---------------------------------------------------------------------------


def step_by_m(recs, ab, layout: str) -> dict:
    """Per M, times of one 7B step's launches (qkv, wo, gate_up, down x 32
    layers, lm_head once where `recs` has it): the call's ms, bound, plain
    and torch.matmul ms from `recs`, and the A/B's prepared-launch ms of the
    new and the scalar kernel (each the mean of its two turns)."""
    per = {"qkv": N_LAYER, "wo": N_LAYER, "gate_up": N_LAYER,
           "down": N_LAYER, "lm_head": 1}
    out = {}
    for M in AB_MS:
        rs = [r for r in recs if r["M"] == M and r["case"] in per]
        cases = {r["case"] for r in rs}
        abr = [r for r in ab if r["M"] == M and r["layout"] == layout
               and r["case"] in cases]
        row = {k: sum(r[k] * per[r["case"]] for r in rs)
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
        row["ab_new_ms"] = sum(np.mean(r["new_ms"]) * per[r["case"]]
                               for r in abr)
        row["ab_old_ms"] = sum(np.mean(r["old_ms"]) * per[r["case"]]
                               for r in abr)
        row["launches"] = sum(per[c] for c in cases)
        out[M] = row
    return out


def attn_by_case(recs, label) -> dict:
    """Per timed attention case, ms of a 7B step's 32 launches: kernel,
    bound, plain and SDPA (bf16 only); and one launch's kernel ms."""
    out = {}
    for r in recs:
        row = {k: (None if r.get(k) is None else N_LAYER * r[k])
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
        row["ms_one_launch"] = r["ms"]
        row["bound_by"] = r["bound_by"]
        out[label(r)] = row
    return out


def kernel_entries(qrecs, arecs, precs, e2e, serve, k3recs, k3eq,
                   cinf, ab, dsamp, multi, archs,
                   session_paths) -> list[dict]:
    """One entry per kernel: times summed over the launches of one decode
    step at 7B (qmatmul: the 4 projections x 32 layers + lm_head at M=1;
    dense_attention: 32 layers at W=512, bf16 cache, full window;
    paged_attention: 32 layers over 64 streams at n_past 200, bf16 pool,
    page 256). `launches` counts the main path that runs the kernel most:
    `infer` for qmatmul and dense_attention, the paged server for
    paged_attention; `launches_by_path` has the count of each path's own
    run: `infer`, the paged server and the dense engine, and for qmatmul
    and dense_attention the device-sampling path's graph replays, and for
    qmatmul, dense_attention and paged_attention the multi-step paths'
    graph replays (each capture's count times its replays): the server
    with multi_step=16 (`multi_step_server`) and the decode loops driven
    directly (`multi_step_loops`), and the six other architectures'
    runs (`archs`), whose kernel cases are in `archs_by_case`: K1 one
    decode token of each model at M=1, K2 at Falcon-7B's decode, K4 at
    MPT-7B's paged cell; and the runs of `session_paths`: greedy `infer`
    on the GGUF load, perplexity, a session continued from its snapshot
    and the verify harness."""
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
    # K3: the 4 coalesced projections x 32 layers of a decode token at M=1
    dec3 = [r for r in k3recs if r["M"] == 1]
    entries.append({
        "name": "qmatmul_coalesced", "route": "cuda",
        "source": "llm_tpu_torch/csrc/qmatmul.cu",
        "source_also": ["llm_tpu_torch/csrc/qmatmul_tc.cuh"],
        "replaces": "llm_tpu/ops/qmatmul.py:436",
        "replaces_also": ["llm_tpu/ops/qmatmul.py:475",
                          "llm_tpu/ops/qmatmul.py:268"],
        "launches": cinf["launches"]["qmatmul_coalesced"],
        "launches_by_path": {"infer_coalesced":
                             cinf["launches"]["qmatmul_coalesced"]},
        "max_abs_err": max(r["max_abs_err"] for r in k3recs),
        "max_abs_err_vs_k1": max(r["max_abs_err"] for r in k3eq),
        "ms": total("ms", dec3, qw), "plain_ms": total("plain_ms", dec3, qw),
        "bound_ms": total("bound_ms", dec3, qw),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in dec3)
        else "operations",
        "library_ms": total("library_ms", dec3, qw),
        "per": "one 7B decode token's coalesced launches: 128 at M=1 "
               "(lm_head stays planes)",
        "tolerance": "|y - plain| <= 2^-7 (|x| @ |W|); bit-equal to K1",
        "by_M": step_by_m(k3recs, ab, "coalesced"),
    })
    for name, recs, all_recs, w, path, rep, extra in (
        ("qmatmul", dec, qrecs, qw, "infer", "llm_tpu/ops/qmatmul.py:560",
         {"source": "llm_tpu_torch/csrc/qmatmul.cu",
          "source_also": ["llm_tpu_torch/csrc/qmatmul_tc.cuh"],
          "replaces_also": ["llm_tpu/ops/qmatmul.py:651",
                            "llm_tpu/ops/qmatmul.py:436",
                            "llm_tpu/ops/qmatmul.py:475"],
          "per": "one 7B decode token: 129 launches at M=1",
          "tolerance": "|y - plain| <= 2^-7 (|x| @ |W|)",
          "by_M": step_by_m(qrecs, ab, "planes")}),
        ("dense_attention", attn, arecs, per_layer, "infer",
         "llm_tpu/ops/dense_attention.py:195",
         {"source": "llm_tpu_torch/csrc/paged_attention.cu",
          "per": "one 7B decode token: 32 launches, W=512, bf16 cache",
          "tolerance": "m, l, acc within 1e-5 relative",
          "by_case": attn_by_case(
              [r for r in arecs if "ms" in r],
              lambda r: f"{r['case']}_{r['kv']}_B{r['B']}_W{r['W']}")}),
        ("paged_attention", paged, precs, per_layer, "serve_paged",
         "llm_tpu/ops/paged_attention.py:224",
         {"source": "llm_tpu_torch/csrc/paged_attention.cu",
          "per": "one 7B decode step of 64 streams at n_past 200: 32 "
                 "launches, bf16 pool, page 256",
          "tolerance": "m, l, acc within 1e-5 relative; n_past 0 exact",
          "by_case": attn_by_case(
              precs, lambda r: f"{r['case']}_{r['kv']}_page{r['page']}"
                               f"_rep{r['rep']}")}),
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
    # the device-sampling path's launches: each capture's count times the
    # replays of the greedy runs (a replay is not seen by the counters)
    for e in entries[1:3]:
        e["launches_by_path"]["device_sampling"] = sum(
            g["launches_per_replay"][e["name"]] * g["replays"]
            for r in dsamp["greedy_runs"] for g in r["graphs"])
    loops = [g for name in ("paged_int8_b16", "dense_bf16_b8",
                            "paged_int8_b64")
             for g in multi[name]["graphs"]]
    for e in entries[1:4]:
        e["launches_by_path"]["multi_step_server"] = \
            multi["server"]["graph_launches"][e["name"]]
        e["launches_by_path"]["multi_step_loops"] = sum(
            g["launches_per_replay"][e["name"]] * g["replays"]
            for g in loops)
    for e in entries[1:4]:
        e["launches_by_path"]["archs"] = archs["launches"][e["name"]]
        for path, ls in session_paths.items():
            e["launches_by_path"][path] = ls[e["name"]]
    entries[1]["archs_by_case"] = {
        name: m["qmatmul"]["per_token"]
        for name, m in archs["models"].items()}
    for e in entries[2:4]:
        r = archs["kernel_cases"][e["name"]]
        e["archs_by_case"] = {r["case"]: {k: r[k] for k in (
            "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "max_abs_err")}}
    for e in entries[1:4]:
        errs = ([r["max_abs_err"] for m in archs["models"].values()
                 for r in m["qmatmul"]["cases"]] if e["name"] == "qmatmul"
                else [archs["kernel_cases"][e["name"]]["max_abs_err"]])
        e["max_abs_err"] = max([e["max_abs_err"], *errs])
    # qmatmul's launches by consumer path, in each path's own run
    entries[1]["launches_by_consumer_path"] = {
        name: {"swapped": ls["qmatmul_swapped"], "wide": ls["qmatmul_wide"]}
        for name, ls in (("infer", e2e["launches"]),
                         ("serve_paged", serve["paged_launches"]),
                         ("serve_dense", serve["dense_launches"]),
                         *session_paths.items())}
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

    t_build = time.monotonic()
    # the compiler's report (registers, spills, SASS a weight), built
    # beside the kernels and read before any timing, so that its compiles
    # take no host time from the phases
    report = subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch.probes.kernel_report"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        built = _build.build(["qmatmul", "paged_attention", "qmatmul_probe"])
    except BaseException:
        report.kill()
        report.wait()
        raise
    emit({"build": {"nvcc_s": built}})
    results["build"] = built
    rep_out, rep_err = report.communicate()
    if report.returncode != 0:
        fail(f"kernel_report: {rep_err[-2000:]}")
    results["kernel_report"] = json.loads(rep_out.strip().splitlines()[-1])
    emit({k: results["kernel_report"][k]
          for k in ("dequant_sass", "main_loop_sass")})

    phase_s = results["phase_s"] = {}
    clock = [t_build]

    def lap(name):
        now = time.monotonic()
        phase_s[name] = now - clock[0]
        clock[0] = now

    lap("build")
    timer = Timer(dev)
    qrecs = qmatmul_phase(dev, timer)
    lap("qmatmul")
    k3eq, k3recs = coalesced_phase(dev, timer)
    lap("qmatmul_coalesced")
    ab = ab_phase(dev, timer)
    results["qmatmul_ab"] = ab
    emit({"qmatmul_ab": ab})
    lap("qmatmul_ab")
    arecs = attention_phase(dev, timer)
    precs = paged_phase(dev, timer)
    mrecs = attention_matrix(dev) + [check_repeat(dev)]
    lap("attention")
    checks = probe_checks(dev) + probe_checks_7b(dev)
    lap("probe_checks")
    cases = qrecs + k3eq + k3recs + ab + arecs + precs + mrecs + checks
    results["kernel_cases"] = cases
    emit({"kernel_cases": cases})
    bad = [r for r in cases if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad[:3]}")

    e2e, model = e2e_phase(dev)
    results["e2e"] = e2e
    emit({"e2e": e2e})
    lap("e2e")

    dsamp = device_sampling_phase(model, dev, e2e)
    results["device_sampling"] = dsamp
    emit({"device_sampling": dsamp})
    lap("device_sampling")

    cinf = coalesced_infer_phase(model, dev)
    results["infer_coalesced"] = cinf
    emit({"infer_coalesced": cinf})
    lap("infer_coalesced")

    serve = serve_phase(model, dev)
    results["serve"] = serve
    emit({"serve": serve})
    lap("serve")

    multi = multi_step_phase(model, dev, serve)
    results["multi_step"] = multi
    emit({"multi_step": multi})
    lap("multi_step")

    gguf, gguf_path = gguf_phase(model, dev, e2e)
    results["gguf"] = gguf
    emit({"gguf": gguf})
    lap("gguf")

    ppl = perplexity_phase(model, dev)
    results["perplexity"] = ppl
    emit({"perplexity": ppl})
    lap("perplexity")

    snap = snapshot_phase(model, dev, e2e)
    results["snapshot"] = snap
    emit({"snapshot": snap})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("snapshot")

    ver = verify_phase(dev, gguf_path)
    results["verify"] = ver
    emit({"verify": ver})
    gc.collect()
    torch.cuda.empty_cache()
    lap("verify")
    session_paths = {"gguf_infer": gguf["launches"],
                     "perplexity": ppl["launches"],
                     "snapshot": snap["launches"],
                     "verify": ver["launches"]}

    archs = archs_phase(dev, timer)
    results["archs"] = archs
    emit({"archs": archs})
    lap("archs")

    probes = probe_phase(dev)
    results["probes"] = probes
    lap("probes")

    kernels = kernel_entries(qrecs, arecs, precs, e2e, serve, k3recs, k3eq,
                             cinf, ab, dsamp, multi, archs, session_paths)
    kernels += probe_entries(probes, checks, dev, timer)
    del timer
    lap("kernel_entries")
    emit({"phase_s": phase_s})
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
