#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`llm_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build:   nvcc compiles csrc/qmatmul.cu (the tensor-core kernel of
            csrc/qmatmul_tc.cuh), csrc/paged_attention.cu (which also
            serves the dense cache's attention), csrc/qmatmul_probe.cu
            (the probes' cuts and dequant modes of the same tensor-core
            kernels) and csrc/codecs.cu (the load's decode of the GGML
            blocks, the counterpart of llm_tpu/native/codecs.cpp) for
            sm_90a, all at once, into build/kernels/; beside them,
            `llm_tpu_torch.probes.kernel_report` compiles its own copies
            for the compiler's report (registers, shared memory, spills of
            every kernel; SASS instructions a weight of the dequant and of
            the main loop of the q4_0 kernels, their cuts and modes).
2. kernels: each kernel's wrapper runs on the card at the LLaMA-7B shapes
            of the main paths (qmatmul at M = 1, 8, 16, 64, 128 and 512,
            M > 32 on the wgmma path; dense attention at B = 1 and 8; paged
            attention at B = 4-64, GQA rep 8 on the tensor-core branch) and is
            held against its plain PyTorch version on the same inputs;
            times of kernel, plain version, one PyTorch library call, and
            the card's bound. qmatmul is also held for all 10 formats (both
            scale kinds) at a small shape at M = 1, 4, 8, 16, 64 and 512.
            K3 (qmatmul over the coalesced buffer) is held bit-equal to K1
            on the same weights for all 10 formats and at the 7B
            projections, and timed at M = 1-512. Every probe cut (stream,
            unpack, dequant; q4_0, q8_0 and q6_k over planes and coalesced
            buffers; at M = 1, 8 and 512, so on both consumer paths), mode
            and tiling is held against its plain version, at a small shape
            and at the 7B shape its probe runs it. The attention kernel is
            also held at small shapes off the 7B ones (D 64 / 80 / 256, 4
            / 8 / 71 query heads a kv head, page 24, all four pools, ALiBi,
            n_past 0, mid-page and full), and repeated launches, and a
            launch after one with another grid, must give bit-equal
            results on both branches.
            Each attention case records whether it took the tensor-core
            branch (`LAUNCHES_GQA_MMA`), which must match its plan; the
            compiler's report must show HGMMA and no HMMA in the wide
            qmatmul kernels and HMMA, without spills, in the GQA branch.
            The shard shapes: K1 over each projection of a model=2 rank
            of LLaMA-7B (q|k|v R 6144, wo K 2048, gate|up R 11008, down
            K 5504, head R 16000) at M = 1 and 64, K2 and K4 (int8) over
            16 local heads, each against its plain version and timed. The
            multi-host row's shapes: K1 over the 7B projections at M = 128
            (a row's [2, 64] prefill chunk), K2 (bf16) and K4 (int8) at
            the row's 2 streams. The codec kernel (`native.decode`): all
            ten formats at a small shape with edge blocks and at the 7B
            shapes (K 4096 x R 11008; Q6_K also x 32000) bit-equal to its
            plain version on the card and to the host numpy decode.
3. e2e:     a full-width random LLaMA-7B Q4_0 checkpoint (seed 0, ~3.9 GB,
            written under build/smoke/, removed by the gguf phase) is loaded
            on the card (`load_record`: its wall time, untouched, and the
            codec kernel's launches held to the quantized matrices the
            load packs, one each, as at every load below), then loaded
            once more with each part timed (`load_parts`: the copy out of
            the file, the H2D of the raw bytes, the decode, the planes),
            and
            `InferenceSession.infer` answers three greedy
            prompts (16, 64 and 1100 tokens, 32 new tokens each) with the
            launch counters set to 0 just before and read just after
            (prompt chunks of 512 rows on qmatmul's wide path, decode steps
            on its swapped path). The first prefill and decode logits are
            then held against the port's plain path on the same card.
   pack:    the e2e file's pack (`models/pack_cache.py`, what `llm-tpu-torch
            pack` writes) next to it under build/smoke/, then a warm load
            with the transcode forbidden: every plane bit-equal to the cold
            load's; cold load, write and warm load s and the pack's bytes;
            the pack removed. The same on MPT-7B Q4_K inside `archs`.
   parallel: a gloo world of 2 ranks on the one card
            (`parallel/launch.spawn`, the kernels already built), each
            loading the e2e file whole: tensor parallelism over a (1, 2)
            mesh, the prompt and 16 forced tokens held against the
            single-card forward (relative L2 2^-8 and top-1; layer by
            layer where they diverge), one decode forward launching
            exactly 129 K1 and 32 K2, its ms a token beside the single
            card's, the audit's bytes a token (exact), host-staged
            collective ms and K1 at the rank's shapes; the dense bf16 and
            paged int8 engines under the mesh on 4 serve prompts (16 new
            each; the prompts cut to their first 64 tokens, one prefill
            chunk), launches held to their forwards, texts equal on both
            ranks; a multi-step run (blocks of 4, eager under the mesh,
            counted); the pipeline (2 stages of 16 layers, 2 microbatches of
            2 streams) and the ring prefill of the 1100-token prompt held
            against the single-card forward, launches exact. Then a world
            of one on nccl over a 2-layer full-width model, held against
            its unsharded forward. The ranks share one card and gloo
            stages every collective through the host: not a multi-GPU
            speed.
   multihost: a gloo world of 2 ranks on the one card over the same
            file, (data, model) = (2, 1), a host one rank
            (`parallel/multihost.py`): each row's 2 serve prompts (cut to
            64 tokens, 16 new, greedy) through MultiHostEngine (dense
            bf16) and MultiHostPagedEngine (int8, page 256) host-stepped,
            launches held to their forwards (129 K1 and 32 K2 or K4 a
            decode forward), a rank's decode step timed with its control
            all-gathers; the paged engine's blocks of 16 (greedy device
            sampler) as CUDA graphs, none eager; an LlmServer on each row
            (two completions at temperature 0, a live /admin/checkpoint
            refused, the consensus stop); the coordinated per-rank
            checkpoint (`.host0`, `.host1`) of a paged engine with a
            stream in flight, restored in the same world with the
            uninterrupted run's tokens, a swapped file refused; each row's
            tokens held against single-card engines in the same rank
            (equal, or teacher-forced logits within 2^-8). Then `serve
            --multihost` of a world of one on nccl through the cli (the
            2-layer full-width model): one completion, SIGINT, exit 0.
            The ranks share one card: not a multi-card speed.
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
   speculative: speculative decoding on the e2e model (still loaded)
            with two drafts: the target itself, and a draft at the
            published geometry of JackFram/llama-160m (768 wide, 12
            layers of 12 heads of 64, n_ff 3072, Q4_0, seed 1, written
            under build/smoke/ and freed at the end). K1 at the new
            shapes against its plain version and torch.matmul: the 7B
            target at M=4, the draft at M=1 and 16. (i) SpeculativeSession
            (k=4) over the e2e 64-token prompt, 32 new greedy tokens, each
            draft: tokens equal to the plain T=1 path's (at the first
            difference both paths' logits of the two tokens are printed
            and it counts only where the plain row's top-2 gap is below
            the two rows' largest difference); the plain tokens against
            the e2e phase's host chain (repetition 1.3, EoT banned): they
            may differ only where that chain penalizes or bans the argmax;
            a second pass from position 0 timed by CUDA events and wall,
            its tokens equal to the first's, the launch counters set to 0
            just before it and held to its forwards, each graph's
            launches a replay (T=1: 4 n_layer + 1 K1 and n_layer K2;
            T=k: 4 n_layer + 1 K1) and its replays against the rounds and
            the formula, one replay of the verify and both bonus graphs
            bit-equal to its eager run, a profiled round's busy share.
            (ii) SampledSpeculativeSession, self-draft, temperature 0.8:
            two runs with seed 1 equal. (iii) SpeculativeEngine, bf16, 16
            slots, the 160M draft, the serve phase's 16 prompts (chunks of
            512), 32 new each: tokens equal to a plain Engine's by the
            same rule; tok/s, a round's parts (draft, verify with K1 at
            M=64 in situ from a profiled verify, host). (iv)
            SampledSpeculativeEngine over 4 of the prompts, top-k 40 at
            0.8, seeded twice: equal. (v) PagedSpeculativeEngine (int8
            pool, page 256, prefix cache) against a plain PagedEngine, the
            eager T=k page pass's wall and kernel ms;
            PagedSampledSpeculativeEngine over 4 prompts, its T=1 tail
            evals launching K4. (vi) LlmServer over PagedSpeculativeEngine:
            16 concurrent temperature-0 completions, tokens equal to (v)'s.
            Every run's launches are held exactly to the forwards it ran;
            `speculative_summary` is the phase's line.
   archs:   the six other architectures, each written with
            `make_bench_file` at its published width (seed 0, under
            build/smoke/, removed after loading) and loaded on the card:
            8 of MPT-7B Q4_K's 32 layers (vocab 50,432, ALiBi, tied head,
            context 8192), GPT-2 117M Q8_0 (context 2048, capped at its
            1024 positions), StableLM-3B Q5_1 (GPT-NeoX, 32 layers), and 4
            layers of GPT-J-6B Q4_0, BLOOM-7B1 Q4_0 and Falcon-7B Q4_0.
            Each: greedy host-sampled `infer` (MPT: prompts of 64 and 1100
            tokens, 32 new; the others 64 and 16), launches counted as in
            e2e from the spec; the load timed as in e2e (MPT: its parts
            too, and layer 0 and the embedding rebuilt from blocks decoded
            on the host, every plane bit-equal); the first prefill and
            decode logits against
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
5. probes:  P2 (`llm_tpu_torch.probes.kernel_decompose`, M = 8, 1 and
            512: K1's swapped path, and its wide path at 256 tokens a
            block), P3
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
    p = qm.plan(w, M, num_sms())
    rec = {"case": name, "fmt": w.fmt_name, "scale_packed": w.scale_packed,
           "layout": type(w).__name__, "M": M, "K": w.k, "R": w.r,
           "path": p.path, "bm": p.bm, "splits": p.splits,
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
        # and its prefill chunks; a multi-host row's [2, 64] chunk (128)
        for M in (1, 8, 16, 64, 128, N_BATCH):
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


def gqa_counted(fn):
    """fn()'s result (synchronized) and the launches of the tensor-core
    branch it made (LAUNCHES_GQA_MMA read before and after: 0 or 1)."""
    from llm_tpu_torch.ops import paged_attention as pa

    before = pa.LAUNCHES_GQA_MMA
    out = fn()
    torch.cuda.synchronize()
    n = pa.LAUNCHES_GQA_MMA - before
    if n not in (0, 1):
        fail(f"attention: {n} launches of the GQA branch in one call")
    return out, n


def check_attention(name, kv, W, n_past, hkv, rep, alibi, rng, dev, timer,
                    timed, d=D) -> dict:
    """The dense pass over a [2, B, hkv, 2048, d] cache, one stream per
    entry of `n_past`."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
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
    got, mma = gqa_counted(lambda: da.dense_attention_pass(*args))
    ok, errs = attn_held(got, da.dense_attention_plain(*args), npast)
    plan = pa.launch_plan(B, hkv, rep, d, S, W, ck.dtype, num_sms())
    rec = {"case": name, "kv": kv, "W": W, "B": B, "n_past": list(n_past),
           "Hkv": hkv, "rep": rep, "alibi": alibi, "mma": plan.mma,
           "gqa_mma_launches": mma, "ok": bool(ok) and mma == int(plan.mma),
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
    # 64 query heads over 8 kv heads (LLaMA-70B's grouping), and rep 4;
    # int8 and int4 at both: the two sides of the tensor-core branch's
    # threshold (paged_attention.MMA_MIN_REP)
    *(("gqa_alibi", kv, 128, 16, ("upto", 1100), 8, rep, True)
      for kv in ("bf16", "int8", "int4") for rep in (8, 4)),
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
    got, mma = gqa_counted(lambda: pa.paged_attention_pass(*args))
    ref = pa.paged_attention_plain(*args)
    ok, errs = attn_held(got, ref, npast)
    plan = pa.launch_plan(B, hkv, rep, D, page, wp * page, pk.dtype,
                          num_sms())
    rec = {"case": name, "kv": kv, "page": page, "B": B, "Hkv": hkv,
           "rep": rep, "alibi": alibi, "window_pages": wp,
           "n_past_max": int(npast.max()), "n_past_sum": int(npast.sum()),
           "mma": plan.mma, "gqa_mma_launches": mma,
           "ok": bool(ok) and mma == int(plan.mma),
           "max_abs_err": max(errs), "errs_m_l_acc": errs}
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
    got, mma = gqa_counted(lambda: pa.paged_attention_pass(*args))
    ok, errs = attn_held(got, pa.paged_attention_plain(*args), npast)
    plan = pa.launch_plan(len(n_past), hkv, rep, d, page, wp * page,
                          pk.dtype, num_sms())
    return {"case": "matrix", "kv": kv, "D": d, "rep": rep, "Hkv": hkv,
            "alibi": alibi, "page": page, "B": len(n_past),
            "tile": plan.tile, "tps": plan.tps, "pipe": plan.pipe,
            "mma": plan.mma, "vec": plan.vec, "gqa_mma_launches": mma,
            "ok": bool(ok) and mma == int(plan.mma),
            "max_abs_err": max(errs), "errs_m_l_acc": errs}


def dense_matrix_case(kv, d, rep, rng, dev) -> dict:
    """The dense cache at head dim d: S = 100 positions, window 100."""
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import paged_attention as pa
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
    got, mma = gqa_counted(lambda: da.dense_attention_pass(*args))
    ok, errs = attn_held(got, da.dense_attention_plain(*args), npast)
    plan = pa.launch_plan(len(n_past), hkv, rep, d, S, S, ck.dtype,
                          num_sms())
    return {"case": "matrix_dense", "kv": kv, "D": d, "rep": rep,
            "alibi": True, "W": S, "mma": plan.mma,
            "gqa_mma_launches": mma, "ok": bool(ok) and mma == int(plan.mma),
            "max_abs_err": max(errs),
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
    order, and every ticket is back at 0 after a launch; on both branches
    (rep 1, and the tensor-core branch at GQA rep 8 and rep 71)."""
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

    # the tensor-core branch: GQA rep 8 paged, Falcon-7B's rep 71 dense
    gqa = paged(paged_inputs("bf16", 128, 16, ("upto", 1100), 8, 8, True,
                             rng, dev, layers))
    fk = torch.randn((2, 1, 1, CTX, 64), generator=g, device=dev).bfloat16()
    fv = torch.randn((2, 1, 1, CTX, 64), generator=g, device=dev).bfloat16()
    fq = torch.randn((1, 1, 1, 71, 64), generator=g, device=dev)
    fspec = SimpleNamespace(kq_scale=0.125)

    def falcon(W):
        return lambda: da.dense_attention_pass(fspec, fk, fv, None, None,
                                               npast, W, 1, fq)

    out = {"case": "repeat", "ok": True}
    for name, fn, other in (("paged", a, b), ("dense", dense(512),
                                               dense(2048)),
                            ("paged_gqa", gqa, b),
                            ("dense_gqa", falcon(512), falcon(2048))):
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
# phase 2b: the codec kernel (native.decode) and the loads it serves


# (case, K, R) of the codec checks: a small shape with edge blocks, a 7B
# FFN tensor (K 4096 x R 11008) and, for Q6_K, the usual K-quant of a 7B
# output tensor (K 4096 x R 32000)
CODEC_CASES = [("small", 512, 24, True), ("7b_ffn", E, FF, False)]
CODEC_Q6K_HEAD = ("7b_head", E, V, False)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (as ints), to compare -0.0 and NaN
    payloads too; other tensors as they are."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def decoded_equal(a, b) -> tuple[bool, float]:
    """Two decodings (q, scale, bias) bit for bit, and their largest
    absolute difference (0 when equal)."""
    ok, err = True, 0.0
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False, math.inf
        if x is None:
            continue
        ok &= x.shape == y.shape and bool(torch.equal(bits(x), bits(y)))
        if x.shape == y.shape:
            err = max(err, float((x.double() - y.double()).abs().max()))
    return ok, err


def host_decode(t, data, K: int, R: int, device="cpu") -> tuple:
    """numpy's `ggml/quant.decode_blocks` as `decode_ggml` returns a
    decode, (q, scale, bias) [R, ...] on `device`: the host decode the
    port's loads took for the K-quants before the codec kernel."""
    from llm_tpu_torch.ggml.quant import decode_blocks

    dec = decode_blocks(t, data, K * R)
    return tuple(None if a is None else torch.from_numpy(
        np.ascontiguousarray(a, dtype).reshape(R, -1)).to(device)
        for a, dtype in ((dec.q, np.int32), (dec.scale, np.float32),
                         (dec.bias, np.float32)))


def codec_checks(dev, timer) -> list[dict]:
    """`native.decode` (csrc/codecs.cu) for all ten formats, at a small
    shape with edge blocks (`testing.codec_blocks`: d 0, -0, negative,
    subnormal; scale bytes 0xFF, 0x80, 0x7F) and at the 7B shapes, bit-equal
    (q, and scale and bias as bits) to its plain version
    (`packing.decode_plain`) on the same card and to the host numpy
    `ggml/quant.decode_blocks`; kernel and plain ms, the bound (the raw
    bytes read, q, scale and bias written, over HBM). No PyTorch call
    decodes GGML blocks: library_ms is None."""
    from llm_tpu_torch import native
    from llm_tpu_torch.ops import packing
    from llm_tpu_torch.testing import codec_blocks

    rng = np.random.default_rng(17)
    recs = []
    for t in packing.FORMATS:
        cases = CODEC_CASES + ([CODEC_Q6K_HEAD] if t.name == "Q6_K" else [])
        for case, K, R, edges in cases:
            raw_np = codec_blocks(t, K, R, rng, edges=edges)
            raw = torch.from_numpy(raw_np).to(dev)
            got = native.decode(t, raw, K, R)
            plain = packing.decode_plain(t, raw, K, R)
            torch.cuda.synchronize()
            host = host_decode(t, raw_np, K, R)
            got_cpu = tuple(None if a is None else a.cpu() for a in got)
            eq_plain, err_plain = decoded_equal(got, plain)
            eq_host, err_host = decoded_equal(got_cpu, host)
            del plain, got_cpu, host
            rec = {"case": f"{t.name}_{case}", "format": t.name, "K": K,
                   "R": R, "edges": edges, "ok": eq_plain and eq_host,
                   "bit_equal_plain": eq_plain, "bit_equal_host": eq_host,
                   "max_abs_err": max(err_plain, err_host)}
            if case != "small":
                n_bytes = raw.numel() + sum(
                    a.numel() * a.element_size() for a in got
                    if a is not None)
                del got
                rec["ms"] = timer.ms(lambda: native.decode(t, raw, K, R))
                rec["plain_ms"] = timer.ms(
                    lambda: packing.decode_plain(t, raw, K, R), iters=3)
                rec["library_ms"] = None
                rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, 0.0)
                rec["bytes"] = n_bytes
            recs.append(rec)
            del raw
            torch.cuda.empty_cache()
    return recs


CODEC_LOADS: list[dict] = []  # every load_record, in the order they ran


def device_allocs() -> int:
    """cudaMalloc calls so far (the caching allocator's `num_device_alloc`;
    -1 on a PyTorch that does not count them)."""
    return torch.cuda.memory_stats().get("num_device_alloc", -1)


@contextlib.contextmanager
def load_record(path_name: str):
    """Around one load, which it does not slow: its wall time (a
    synchronize before and after, none inside), the cudaMalloc calls it
    made, and the codec kernel's launches (`native.LAUNCHES`, set to 0 just
    before and read just after), held to the quantized matrices the load
    packed (each decoded once, on the card). Yields the record; it is
    complete after the block."""
    from llm_tpu_torch import native
    from llm_tpu_torch.models import params

    rec = {"path": path_name}
    names: set = set()
    matrix = params.WeightSource.matrix

    def seen(self, name, rows=None):
        if self.reader.tensors[name].element_type.is_quantized:
            names.add(name)
        return matrix(self, name, rows)

    params.WeightSource.matrix = seen
    torch.cuda.synchronize()
    native.LAUNCHES = 0
    allocs = device_allocs()
    t0 = time.monotonic()
    try:
        yield rec
        torch.cuda.synchronize()
        rec["load_s"] = time.monotonic() - t0
        rec["device_allocs"] = device_allocs() - allocs
        rec["codec_launches"] = native.LAUNCHES
    finally:
        params.WeightSource.matrix = matrix
    rec["quantized_matrices"] = len(names)
    if rec["codec_launches"] != len(names):
        fail(f"{path_name}: {rec['codec_launches']} codec launches for "
             f"{len(names)} quantized matrices")
    CODEC_LOADS.append(rec)


def part_hooks() -> list:
    """(module, function, part) of the load's four parts: the block bytes
    copied out of the memory-mapped file (`packing.raw_bytes`), that plus
    their copy to the card and the decode (`decode_ggml`), the decode
    (`native.decode`), and the planes (`pack_decoded`)."""
    from llm_tpu_torch import native
    from llm_tpu_torch.models import params
    from llm_tpu_torch.ops import packing

    return [(packing, "raw_bytes", "read_s"), (native, "decode", "decode_s"),
            *[(m, f, part) for m in (packing, params)
              for f, part in (("decode_ggml", "decode_ggml_s"),
                              ("pack_decoded", "pack_s"))]]


def load_parts(load, hooks=None) -> dict:
    """The parts of one more load, `load()`, whose result is dropped: each
    call of a hooked function (`part_hooks()` by default) is timed with a
    synchronize after it, so this load is slower than the one `load_record`
    times, and serves only to split it. The caching allocator's free
    blocks are released first, as they are before the main path's load.
    Returns the load's wall time, its parts (`h2d_s` is `decode_ggml` less
    the read and the decode; `other_s` the norms, the vocabulary, the
    spec), and the cudaMalloc calls of each part."""
    acc: dict = {}
    allocs: dict = {}
    saved = []

    def timed(fn, part):
        def run(*a, **k):
            a0, t0 = device_allocs(), time.monotonic()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[part] = acc.get(part, 0.0) + time.monotonic() - t0
            allocs[part] = allocs.get(part, 0) + device_allocs() - a0
            return out
        return run

    for mod, attr, part in hooks or part_hooks():
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(getattr(mod, attr), part))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        model = load()
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    read, dec = acc.get("read_s", 0.0), acc.get("decode_s", 0.0)
    ggml, pack = acc.get("decode_ggml_s", 0.0), acc.get("pack_s", 0.0)
    return {"load_s": load_s,
            "parts": {"read_s": read, "h2d_s": ggml - read - dec,
                      "decode_s": dec, "pack_s": pack,
                      "other_s": load_s - ggml - pack},
            "device_allocs": allocs}


def host_decoded_planes(name, model, path, arch, dev) -> dict:
    """Layer 0 and the embedding of a loaded model rebuilt from blocks
    decoded on the host (`ggml/quant.decode_blocks`, then moved to the card
    and packed by `pack_decoded`), every plane bit-equal to the loaded
    model's (decoded on the card)."""
    import dataclasses

    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.models import params
    from llm_tpu_torch.models.spec import get_arch
    from llm_tpu_torch.ops import packing

    spec = model.spec
    reader = GgmlReader(path).load(
        lambda f: (lambda h: (h, h.n_vocab))(get_arch(arch).read_hparams(f)))
    saved = [(m, getattr(m, "decode_ggml")) for m in (packing, params)]
    for m, _ in saved:
        m.decode_ggml = host_decode
    try:
        host = params.build_params(params.WeightSource(reader, dev),
                                   dataclasses.replace(spec, n_layer=1))
    finally:
        for m, fn in saved:
            m.decode_ggml = fn
    n = leaves_equal(name, (model.params.wte, model.params.layers.layer(0)),
                     (host.wte, host.layers.layer(0)),
                     "the card's decode differs from the host's")
    del host
    gc.collect()
    torch.cuda.empty_cache()
    return {"planes_bit_equal": n}


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


def step_profile(step, steps: int = 4, split=None) -> dict:
    """Host wall ms per call of `step` (which must end by reading a result
    back, as sampling does), and the device kernels torch.profiler sees
    over `steps` more calls: their time, launches and the card's busy
    share of the untraced wall time. `split` (kernel name -> category)
    adds the device ms a call of each category."""
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
    extra = {}
    if split is not None:
        cats: dict[str, float] = {}
        for k, (t, _) in by_name.items():
            cats[split(k)] = cats.get(split(k), 0.0) + t / 1e3 / steps
        extra["split_ms_per_step"] = cats
    return {
        **extra,
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

        def load():
            return loader.load(path, "llama", params=loader.ModelParameters(
                context_size=CTX), device=dev)

        with load_record("e2e") as rec:
            model = load()
        out["load_s"] = rec["load_s"]
        out["load"] = rec
        out["load_parts"] = load_parts(load)
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


def http_completion(url: str, body: dict, exact: bool = True) -> dict:
    """POST one completion; for a streamed one, also the client's time to
    its first text fragment. `exact`: it must give max_tokens tokens and
    end at that length."""
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
    if exact and (out["text"].count("<t") != body["max_tokens"]
                  or out["finish"] != "length"):
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

    with load_record("gguf") as rec:
        gm = loader.load(dst, "llama",
                         params=loader.ModelParameters(context_size=CTX),
                         device=dev)
    out["gguf_load_s"] = rec["load_s"]
    out["codec_launches"] = rec["codec_launches"]
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
# phase 4e: speculative decoding on the e2e model


SPEC_K = 4  # draft proposals a round
SPEC_NEW = 32
# the second draft, at the published geometry of JackFram/llama-160m (the
# draft SpecInfer pairs with LLaMA-7B): hidden 768, 12 layers, 12 heads of
# 64, intermediate 3072, vocab 32000, 2048 positions
DRAFT_E, DRAFT_FF, DRAFT_H, DRAFT_LAYERS = 768, 3072, 12, 12
SPEC_SAMPLED_STREAMS = 4  # the sampled engines' requests (host acceptance
#                           in float64 over V = 32000 is the slow part)
SPEC_TEMPERATURE = 0.8
REPEAT_WINDOW = 64  # the host chain's default repetition slot: last 64


def spec_prompts() -> list[list[int]]:
    """The serve phase's 16 prompts (16-700 tokens, seed 4)."""
    rng = np.random.default_rng(4)
    lens = rng.integers(16, 701, SERVE_STREAMS)
    return [rng.integers(1, V, n).tolist() for n in lens]


@contextlib.contextmanager
def all_forwards():
    """Record every forward that any path runs while the block is open,
    eagerly, as a graph's warm-up or as its capture: (n_layer of the spec,
    T == 1, B * T rows past qmatmul's swapped path, paged) each."""
    from llm_tpu_torch import paged as pm
    from llm_tpu_torch import serve as sm
    from llm_tpu_torch import speculative as spm
    from llm_tpu_torch.models import forward as fm
    from llm_tpu_torch.ops import qmatmul as qm

    calls, saved = [], []

    def wrap(mod, name, paged):
        inner = getattr(mod, name)

        def wrapped(spec, params, ids, *a, **k):
            shape = tuple(getattr(ids, "shape", np.shape(ids)))
            calls.append((spec.n_layer, shape[-1] == 1,
                          int(np.prod(shape)) > qm.SWAPPED_MAX_M, paged))
            return inner(spec, params, ids, *a, **k)

        saved.append((mod, name, inner))
        setattr(mod, name, wrapped)

    for mod in (fm, sm, spm):
        wrap(mod, "forward_batched", False)
    for mod in (pm, spm):
        wrap(mod, "paged_forward_batched", True)
    try:
        yield calls
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)


def launches_exact(name, calls) -> dict:
    """The counters against the forwards `all_forwards` recorded: per
    forward 4 n_layer + 1 qmatmul (on the wide path past 32 rows), and per
    T=1 forward n_layer launches of the dense or the paged attention
    kernel; longer forwards take the plain attention."""
    got = read_launches()
    want = {"qmatmul": 0, "qmatmul_swapped": 0, "qmatmul_wide": 0,
            "dense_attention": 0, "paged_attention": 0}
    for L, t1, wide, paged in calls:
        want["qmatmul"] += 4 * L + 1
        want["qmatmul_wide" if wide else "qmatmul_swapped"] += 4 * L + 1
        if t1:
            want["paged_attention" if paged else "dense_attention"] += L
    if got != want:
        fail(f"speculative {name}: kernel launches {got}, expected {want} "
             f"for {len(calls)} forwards")
    return got


def spec_graphs(name, cache, spec, before: Optional[dict] = None) -> list:
    """Each CUDA graph captured over a dense cache of `spec`, held to the
    launches one replay must make: a T=1 step or forward 4 L + 1 qmatmul
    and L dense attention, a T=k forward 4 L + 1 qmatmul and no
    attention kernel. `replays` counts those since `before` (key ->
    replays)."""
    recs = []
    for key, g in cache.graphs.items():
        T = key[3] if key[0] == "forward" else 1
        kind = key[0] if isinstance(key[0], str) else "decode_loop"
        want = {"qmatmul": 4 * spec.n_layer + 1,
                "dense_attention": spec.n_layer if T == 1 else 0,
                "paged_attention": 0}
        if g.launches != want:
            fail(f"speculative {name}: a {kind} graph (T={T}) counted "
                 f"{g.launches} launches a replay, not {want}")
        recs.append({"kind": kind, "T": T, "window": key[1] if kind !=
                     "forward" else key[4], "launches_per_replay": g.launches,
                     "replays": g.replays - (before or {}).get(key, 0),
                     "capture_s": g.capture_s, "pool_bytes": g.pool_bytes})
    return recs


def replays_of(cache) -> dict:
    return {key: g.replays for key, g in cache.graphs.items()}


def graph_launches(recs) -> dict:
    return {k: sum(r["launches_per_replay"][k] * r["replays"] for r in recs)
            for k in ("qmatmul", "dense_attention", "paged_attention")}


def add_launches(total: dict, *parts) -> None:
    for part in parts:
        for k in ("qmatmul", "dense_attention", "paged_attention"):
            total[k] = total.get(k, 0) + part.get(k, 0)


def tokens_held(name, got, want, got_rows, want_rows) -> dict:
    """Greedy tokens of a speculative path `got` against the plain path's
    `want`. Where they first differ, both paths' logits for the two tokens
    are printed with the plain row's top-2 gap; the divergence counts as a
    tie flipped by rounding only where that gap is below the largest
    absolute difference between the two paths' rows at that position (the
    verify path's T=k forward against the T=1 path). After it the two
    contexts differ, so nothing later is compared."""
    rec = {"equal": got == want, "tokens": len(got)}
    if got == want:
        return rec
    n = min(len(got), len(want))
    j = next((i for i in range(n) if got[i] != want[i]), n)
    if j == n:
        fail(f"speculative {name}: {len(got)} tokens against {len(want)}, "
             "equal as far as both go")
    a, b = np.asarray(got_rows[j]), np.asarray(want_rows[j])
    tg, tw = int(got[j]), int(want[j])
    rec.update({
        "first_divergence": j, "token": tg, "plain_token": tw,
        "path_logits": [float(a[tg]), float(a[tw])],
        "plain_logits": [float(b[tg]), float(b[tw])],
        "top2_gap": float(b[tw] - b[tg]),
        "max_abs_row_diff": float(np.abs(a - b).max())})
    emit({"speculative_token_differs": dict(rec, path=name)})
    if not rec["top2_gap"] < rec["max_abs_row_diff"]:
        fail(f"speculative {name}: token {j} is {tg}, the plain path's "
             f"{tw}, top-2 gap {rec['top2_gap']:.4g} not below the rows' "
             f"difference {rec['max_abs_row_diff']:.4g}")
    return rec


def plain_greedy_rows(model, prompt, n: int):
    """`n` greedy tokens after `prompt` on the T=1 path (the prompt as one
    512-row chunk, as the session feeds it; then one captured decode step
    a token, no ban) and the logits row each token was picked from."""
    from llm_tpu_torch.models.forward import (
        decode_loop,
        forward_step,
        init_cache,
        window_bucket,
    )
    from llm_tpu_torch.ops.sampling import DeviceSampler

    spec = model.spec
    cache = init_cache(spec, torch.bfloat16, model.device)
    ids = np.zeros(N_BATCH, np.int64)
    ids[: len(prompt)] = prompt
    logits, _, _ = forward_step(spec, model.params, torch.from_numpy(ids),
                                0, cache, window_bucket(0, spec.n_ctx))
    logits = logits[len(prompt) - 1]
    toks, rows, n_past = [], [], len(prompt)
    for _ in range(n):
        rows.append(logits.cpu().numpy())
        toks.append(int(np.argmax(rows[-1])))
        if toks[-1] == model.eot_token_id():
            break
        t, logits, _, _ = decode_loop(
            spec, model.params, logits, n_past, cache, 1,
            window_bucket(n_past + 1, spec.n_ctx), DeviceSampler.greedy())
        if int(t[0]) != toks[-1]:
            fail("speculative: the decode step's argmax differs from the "
                 "host's")
        n_past += 1
    return toks, rows


def e2e_tokens_held(plain, prompt, e2e_ids, eot) -> dict:
    """The plain greedy tokens against the e2e phase's (host chain
    `topk:k=1`: repetition 1.3 over the last 64 tokens, EoT banned): they
    may differ first only where the plain argmax is a token the chain
    penalizes or bans."""
    if plain == e2e_ids:
        return {"equal": True}
    j = next((i for i, (a, b) in enumerate(zip(plain, e2e_ids)) if a != b),
             min(len(plain), len(e2e_ids)))
    window = (prompt + plain[:j])[-REPEAT_WINDOW:]
    explained = j < len(plain) and (plain[j] in window or plain[j] == eot)
    rec = {"equal": False, "first_divergence": j,
           "explained_by_the_chain": explained}
    if not explained:
        fail(f"speculative: plain greedy tokens differ from the e2e phase's "
             f"at {j} where the host chain changes nothing: {rec}")
    return rec


def timed_module_fn(mod, name, log: list):
    """Wrap mod.<name>: its wall seconds, through the card's work (a
    synchronize after it), appended to `log`. Returns the restore."""
    inner = getattr(mod, name)

    def wrapped(*a, **k):
        t0 = time.monotonic()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        log.append(time.monotonic() - t0)
        return out

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, inner)


def profile_call(fn) -> tuple:
    """fn() under torch.profiler: (its result, the card's kernel ms, K1's
    share of it, kernels launched, the top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    ks = [(e.time_range.end - e.time_range.start, e.name)
          for e in prof.events() if e.device_type == DeviceType.CUDA]
    by: dict[str, float] = {}
    for t, k in ks:
        by[k] = by.get(k, 0.0) + t
    return out, {
        "traced_wall_ms": 1e3 * wall,
        "kernel_ms": sum(t for t, _ in ks) / 1e3 if ks else None,
        "k1_ms": sum(t for t, k in ks if "qmm" in k or "sum_splits" in k)
        / 1e3 if ks else None,
        "launches": len(ks),
        "top": [{"kernel": k[:80], "ms": t / 1e3}
                for k, t in sorted(by.items(), key=lambda kv: -kv[1])[:6]]}


def session_run(model, draft, prompt, plain, dev) -> dict:
    """SpeculativeSession (k = 4) over the prompt, 32 new tokens: a first
    pass that captures the graphs and gives the tokens, held against the
    plain T=1 path; then the same session from position 0 again (caches
    and graphs reused; rows at and past n_past are masked) with the launch
    counters set to 0 just before it: its tokens equal the first pass's,
    ms a token by CUDA events and wall, the launches of each graph and
    their replays against the rounds, each captured graph replayed once
    bit-equal to its eager run, and a profiled round's busy share."""
    from llm_tpu_torch import speculative as sp
    from llm_tpu_torch.models.forward import forward_replay, window_bucket

    s = sp.SpeculativeSession(model, draft, k=SPEC_K,
                              kv_dtype=torch.bfloat16, n_batch=N_BATCH)
    rounds = []
    verify = s._verify

    def recorded(proposals, w):  # (n_past, head row, verify rows) a round
        head = np.array(s.last_logits)
        t = verify(proposals, w)
        rounds.append((s.n_past, head, t))
        return t

    s._verify = recorded
    s.feed_prompt(prompt)
    first = s.generate(SPEC_NEW)
    rows = {}
    for n_past, head, t in rounds:
        for j, row in enumerate([head, *t]):
            rows[n_past - len(prompt) + j] = row
    out = {"tokens_vs_plain": tokens_held(
        "session", first, plain[0], [rows[j] for j in range(len(first))],
        plain[1]), "first_pass_acceptance": s.acceptance_rate}
    rounds.clear()

    # the timed pass, launches counted
    s.n_past, s.tokens, s.accepted, s.drafted = 0, [], 0, 0
    t_before, d_before = replays_of(s.t_cache), replays_of(s.d_cache)
    log = {"draft": [], "verify": [], "bonus": []}
    restore = [timed_module_fn(sp, "decode_loop", log["draft"])]
    bonus = s._eval_bonus

    def timed_bonus(tok, w):
        t0 = time.monotonic()
        r = bonus(tok, w)
        log["bonus"].append(time.monotonic() - t0)
        return r

    def timed_verify(proposals, w):
        t0 = time.monotonic()
        r = recorded(proposals, w)
        log["verify"].append(time.monotonic() - t0)
        return r

    s._verify, s._eval_bonus = timed_verify, timed_bonus
    toks = []
    with all_forwards() as calls:
        zero_launches()
        s.feed_prompt(prompt)
        dev_ms, wall_ms = events_ms(lambda: toks.extend(s.generate(SPEC_NEW)))
        counted = launches_exact("session", calls)
    for r in restore:
        r()
    s._verify, s._eval_bonus = verify, bonus
    if toks != first:
        fail(f"speculative session: the second pass's tokens {toks} differ "
             f"from the first's {first}")
    spec_t, spec_d = model.spec, draft.spec
    tg = spec_graphs("session target", s.t_cache, spec_t, t_before)
    dg = spec_graphs("session draft", s.d_cache, spec_d, d_before)
    # a round: k draft steps, the T=k verify (a T=1 forward when k = 1),
    # and, unless the budget ends it, both models' T=1 bonus evals
    ks = [len(t) for _, _, t in rounds]
    n_rounds, n_bonus = len(ks), len(log["bonus"])
    t_replays = sum(r["replays"] for r in tg)
    d_steps = sum(r["replays"] for r in dg if r["kind"] == "decode_loop")
    d_bonus = sum(r["replays"] for r in dg if r["kind"] == "forward")
    if (t_replays != n_rounds + n_bonus or d_steps != sum(ks)
            or sum(ks) != s.drafted or d_bonus != n_bonus
            or (model.eot_token_id() not in toks
                and len(toks) != s.accepted + n_bonus)):
        fail(f"speculative session: {t_replays} target, {d_steps} "
             f"draft-step and {d_bonus} draft-bonus replays for {n_rounds} "
             f"rounds of k {ks}, {n_bonus} bonus evals, {s.drafted} "
             f"proposals, {s.accepted} accepted, {len(toks)} tokens")
    replayed = graph_launches(tg + dg)
    k1_t, k1_d = 4 * spec_t.n_layer + 1, 4 * spec_d.n_layer + 1
    formula = {"qmatmul": sum(ks) * k1_d + n_rounds * k1_t
               + n_bonus * (k1_t + k1_d),
               "dense_attention": sum(ks) * spec_d.n_layer
               + ks.count(1) * spec_t.n_layer
               + n_bonus * (spec_t.n_layer + spec_d.n_layer),
               "paged_attention": 0}
    if replayed != formula:
        fail(f"speculative session: graph launches {replayed}, formula "
             f"{formula}")

    # one replay of each captured verify and bonus graph against its eager
    # run on the same inputs, at the session's frontier
    w = window_bucket(s.n_past + SPEC_K + 1, spec_t.n_ctx)
    cases = {"verify": (model, s.t_cache, toks[-SPEC_K:]),
             "bonus_target": (model, s.t_cache, toks[-1:]),
             "bonus_draft": (draft, s.d_cache, toks[-1:])}
    bit_equal = {}
    for name, (m, cache, ids) in cases.items():
        ids = torch.tensor([ids], device=dev)
        eager, replay = (forward_replay(m.spec, m.params, ids, [s.n_past],
                                        cache, w, graph=g)
                         for g in (False, True))
        torch.cuda.synchronize()
        bit_equal[name] = bool(torch.equal(eager, replay))
        if not bit_equal[name] or not bool(torch.isfinite(replay).all()):
            fail(f"speculative session: the {name} replay is not "
                 f"bit-equal to its eager run (max |diff| "
                 f"{float((eager - replay).abs().max()):.3g})")
    prof = step_profile(lambda: s.generate(SPEC_K), steps=2)
    med = {k: 1e3 * float(np.median(v)) if v else 0.0
           for k, v in log.items()}
    out.update({
        "tokens": toks, "acceptance": s.acceptance_rate,
        "rounds": n_rounds, "round_k": ks,
        "tokens_per_round": len(toks) / n_rounds,
        "ms_per_token": dev_ms / len(toks),
        "wall_ms_per_token": wall_ms / len(toks),
        "round_ms": med,
        "round_wall_ms": wall_ms / n_rounds,
        # the rest of a round's wall: acceptance, bookkeeping, callbacks
        "host_ms_per_round": (wall_ms - 1e3 * sum(map(sum, log.values())))
        / n_rounds,
        "round_ms_per_call": {"draft": "one decode_loop block of k steps",
                              "verify": "the T=k verify and its read",
                              "bonus": "both models' T=1 bonus evals"},
        "launches_per_round": {k: v / n_rounds for k, v in replayed.items()},
        "counted_launches": counted, "graph_launches": replayed,
        "graphs": tg + dg, "replay_bit_equal": bit_equal,
        "profile": {k: prof[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "device_launches_per_step", "top_device")},
        "profile_how": f"step_profile of generate({SPEC_K}) calls (one or "
                       "more rounds each)",
    })
    out["launches"] = dict(counted)
    add_launches(out["launches"], replayed)
    del s
    return out


def sampled_session_runs(model, prompt) -> dict:
    """SampledSpeculativeSession with the target as its own draft at
    temperature 0.8, twice with seed 1: equal tokens; the acceptance."""
    from llm_tpu_torch import speculative as sp

    runs, launches = [], {}
    for _ in range(2):
        s = sp.SampledSpeculativeSession(model, model, k=SPEC_K,
                                         temperature=SPEC_TEMPERATURE)
        s.feed_prompt(prompt)
        toks = []
        with all_forwards() as calls:
            zero_launches()
            dev_ms, wall_ms = events_ms(
                lambda: toks.extend(s.generate(SPEC_NEW, seed=1)))
            counted = launches_exact("sampled session", calls)
        recs = (spec_graphs("sampled session", s.t_cache, model.spec)
                + spec_graphs("sampled session", s.d_cache, model.spec))
        add_launches(launches, counted, graph_launches(recs))
        runs.append({"tokens": toks, "acceptance": s.acceptance_rate,
                     "accepted": s.accepted, "drafted": s.drafted,
                     "ms_per_token": dev_ms / len(toks),
                     "wall_ms_per_token": wall_ms / len(toks),
                     "graphs": recs})
        del s
    if runs[0]["tokens"] != runs[1]["tokens"] or \
            len(runs[0]["tokens"]) != SPEC_NEW:
        fail(f"speculative sampled session: seeded runs differ: "
             f"{[r['tokens'] for r in runs]}")
    return {"runs": runs, "acceptance": runs[0]["acceptance"],
            "launches": launches,
            "timing_note": "each run captures its own graphs (new caches)"}


def record_rows(engine) -> dict:
    """Record, per request id, the logits row each emitted token was
    picked from (the stream's last_logits when _finish_token runs)."""
    rows: dict[int, list] = {}
    inner = engine._finish_token

    def wrapped(slot, stream, tok, logits_row):
        rows.setdefault(stream.request_id, []).append(
            np.array(stream.last_logits, np.float32))
        return inner(slot, stream, tok, logits_row)

    engine._finish_token = wrapped
    return rows


def engine_run(name, engine, prompts, make_req) -> dict:
    """Submit one request a prompt, step the engine to the end with the
    launch counters set to 0 just before; the new tokens and each token's
    logits row, wall, the steps' log, the exact launches."""
    rows = record_rows(engine)
    log = record_steps(engine)
    ids = [engine.submit(make_req(i, p)) for i, p in enumerate(prompts)]
    with all_forwards() as calls:
        zero_launches()
        t0 = time.monotonic()
        while engine.has_work():
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counted = launches_exact(name, calls)
    fins = [engine.finished[i] for i in ids]
    bad = [f.finish_reason for f in fins
           if f.finish_reason not in ("max_tokens", "eot")]
    if bad:
        fail(f"speculative {name}: requests ended with {bad}")
    return {"tokens": [f.tokens[len(p):] for f, p in zip(fins, prompts)],
            "rows": [rows[i] for i in ids], "wall_s": wall, "log": log,
            "counted_launches": counted,
            "generated": sum(f.generated for f in fins)}


def engine_summary(run, streams: int) -> dict:
    return {"wall_s": run["wall_s"],
            "generated_tok_s": run["generated"] / run["wall_s"],
            **step_summary(run["log"], streams)}


def greedy_req(i, p):
    from llm_tpu_torch.samplers import GreedySampler
    from llm_tpu_torch.serve import GenerationRequest

    return GenerationRequest(prompt=p, max_tokens=SPEC_NEW,
                             sampler=GreedySampler())


def sampled_req(i, p):
    from llm_tpu_torch.ops.sampling import DeviceSampler
    from llm_tpu_torch.serve import GenerationRequest

    return GenerationRequest(
        prompt=p, max_tokens=SPEC_NEW, seed=100 + i,
        device_sampler=DeviceSampler(kind="sample",
                                     temperature=SPEC_TEMPERATURE, top_k=40))


def engines_held(name, got, want) -> list:
    return [tokens_held(f"{name} request {i}", g, w, gr, wr)
            for i, (g, w, gr, wr) in enumerate(zip(
                got["tokens"], want["tokens"], got["rows"], want["rows"]))]


def spec_engine_parts(engine, sp_mod) -> tuple[dict, list]:
    """Time a speculative engine's rounds by part: the draft block (a
    synchronize after it), the verify with its read, and the tail evals
    of the sampled engines; profile one verify in the middle of the run
    (the card's kernel ms, K1's share). Returns (log, restores)."""
    log = {"draft": [], "verify": [], "tail": [], "verify_profile": None}
    restores = [timed_module_fn(sp_mod, name, log["draft"])
                for name in ("decode_loop_batched", "_draft_propose_batched")]
    verify = engine._verify_batch

    def timed_verify(*a, **k):
        if len(log["verify"]) == 10 and log["verify_profile"] is None:
            r, log["verify_profile"] = profile_call(lambda: verify(*a, **k))
            log["verify_profile"]["decoding"] = len(engine._decodable())
            return r
        t0 = time.monotonic()
        r = verify(*a, **k)
        log["verify"].append(time.monotonic() - t0)
        return r

    engine._verify_batch = timed_verify
    if hasattr(engine, "_tail_eval_target"):
        tail = engine._tail_eval_target

        def timed_tail(*a, **k):
            t0 = time.monotonic()
            r = tail(*a, **k)
            torch.cuda.synchronize()
            log["tail"].append(time.monotonic() - t0)
            return r

        engine._tail_eval_target = timed_tail
    return log, restores


def verify_calls(log) -> int:
    """Rounds that ran a verify (one of them profiled, not timed)."""
    return len(log["verify"]) + (log["verify_profile"] is not None)


def parts_summary(log, run, streams: int) -> dict:
    """Median ms of each part of a round, the median step in which every
    stream decoded and no prompt chunk ran, and the host's rest of that
    step (acceptance, bookkeeping): the step less the parts' medians,
    which noise can take below 0."""
    med = {k: (1e3 * float(np.median(log[k])) if log[k] else 0.0)
           for k in ("draft", "verify", "tail")}
    step = step_summary(run["log"], streams)[f"decode_step_ms_{streams}"]
    return {"median_ms": med, "rounds": verify_calls(log),
            "round_ms_all_decoding": step,
            "host_ms": None if step is None else step - sum(med.values()),
            "verify_profile": log["verify_profile"]}


def dense_engines(model, draft, prompts) -> dict:
    """(iii) the dense bf16 SpeculativeEngine (16 slots, the 160M draft)
    against a plain Engine, and (iv) SampledSpeculativeEngine, seeded
    twice, over the first 4 prompts."""
    from llm_tpu_torch import speculative as sp
    from llm_tpu_torch.serve import Engine

    out = {"launches": {}}
    plain = engine_run("plain dense engine", Engine(
        model, max_streams=SERVE_STREAMS, kv_dtype=torch.bfloat16,
        n_batch=N_BATCH), prompts, greedy_req)
    gc.collect()
    torch.cuda.empty_cache()
    engine = sp.SpeculativeEngine(model, draft, k=SPEC_K,
                                  max_streams=SERVE_STREAMS,
                                  kv_dtype=torch.bfloat16, n_batch=N_BATCH)
    parts, restores = spec_engine_parts(engine, sp)
    try:
        run = engine_run("dense SpeculativeEngine", engine, prompts,
                         greedy_req)
    finally:
        for r in restores:
            r()
    tg = spec_graphs("dense engine", engine.cache, model.spec)
    dg = spec_graphs("dense engine draft", engine.d_cache, draft.spec)
    rounds = sum(r["replays"] for r in tg if r["T"] == SPEC_K)
    d_steps = sum(r["replays"] for r in dg if r["kind"] == "dense")
    if d_steps != SPEC_K * rounds or rounds != verify_calls(parts):
        fail(f"speculative dense engine: {rounds} verify replays, "
             f"{d_steps} draft steps, {verify_calls(parts)} rounds")
    wide = [r for r in tg if r["T"] == SPEC_K]
    out["dense"] = {
        "tokens_vs_plain": engines_held("dense engine", run, plain),
        "acceptance": engine.acceptance_rate,
        "plain": engine_summary(plain, SERVE_STREAMS),
        "speculative": engine_summary(run, SERVE_STREAMS),
        "parts": parts_summary(parts, run, SERVE_STREAMS),
        "verify_k1_rows": SERVE_STREAMS * SPEC_K,
        "verify_k1_launches_per_replay": wide[0]["launches_per_replay"],
        "graphs": tg + dg, "counted_launches": run["counted_launches"],
        "plain_counted_launches": plain["counted_launches"]}
    add_launches(out["launches"], run["counted_launches"],
                 graph_launches(tg + dg), plain["counted_launches"])
    del engine, plain, run
    gc.collect()
    torch.cuda.empty_cache()

    sampled = []
    for _ in range(2):
        engine = sp.SampledSpeculativeEngine(
            model, draft, k=SPEC_K, max_streams=SPEC_SAMPLED_STREAMS,
            kv_dtype=torch.bfloat16, n_batch=N_BATCH)
        run = engine_run("dense SampledSpeculativeEngine", engine,
                         prompts[:SPEC_SAMPLED_STREAMS], sampled_req)
        recs = (spec_graphs("sampled engine", engine.cache, model.spec)
                + spec_graphs("sampled engine draft", engine.d_cache,
                              draft.spec))
        add_launches(out["launches"], run["counted_launches"],
                     graph_launches(recs))
        sampled.append({"tokens": run["tokens"],
                        "acceptance": engine.acceptance_rate,
                        **engine_summary(run, SPEC_SAMPLED_STREAMS),
                        "graphs": recs})
        del engine, run
        gc.collect()
    if sampled[0]["tokens"] != sampled[1]["tokens"]:
        fail("speculative sampled engine: seeded runs differ")
    out["sampled"] = sampled
    torch.cuda.empty_cache()
    return out


def paged_spec_engine(model, draft, streams: int, sampled: bool = False):
    from llm_tpu_torch import speculative as sp

    cls = (sp.PagedSampledSpeculativeEngine if sampled
           else sp.PagedSpeculativeEngine)
    return cls(model, draft, k=SPEC_K, max_streams=streams,
               page_size=SERVE_PAGE, kv_dtype="int8", n_batch=N_BATCH,
               prefix_cache=True)


def paged_engines(model, draft, prompts) -> tuple[dict, dict]:
    """(v) PagedSpeculativeEngine (int8 pool, page 256, prefix cache, the
    160M draft) against a plain PagedEngine; its eager T=k page pass's
    host and kernel ms; PagedSampledSpeculativeEngine over the first 4
    prompts, whose T=1 tail evals launch K4 (counted exactly)."""
    from llm_tpu_torch import speculative as sp
    from llm_tpu_torch.paged import PagedEngine

    out = {"launches": {}}
    plain = engine_run("plain paged engine", PagedEngine(
        model, max_streams=SERVE_STREAMS, page_size=SERVE_PAGE,
        kv_dtype="int8", n_batch=N_BATCH, prefix_cache=True), prompts,
        greedy_req)
    gc.collect()
    torch.cuda.empty_cache()
    engine = paged_spec_engine(model, draft, SERVE_STREAMS)
    parts, restores = spec_engine_parts(engine, sp)
    try:
        run = engine_run("PagedSpeculativeEngine", engine, prompts,
                         greedy_req)
    finally:
        for r in restores:
            r()
    dg = spec_graphs("paged engine draft", engine.d_cache, draft.spec)
    out["paged"] = {
        "tokens_vs_plain": engines_held("paged engine", run, plain),
        "acceptance": engine.acceptance_rate,
        "plain": engine_summary(plain, SERVE_STREAMS),
        "speculative": engine_summary(run, SERVE_STREAMS),
        "parts": parts_summary(parts, run, SERVE_STREAMS),
        "page_pass_note": "verify = the eager T=k paged forward (plain "
                          "page pass) with its read; verify_profile its "
                          "kernels in one round",
        "graphs": dg, "counted_launches": run["counted_launches"],
        "plain_counted_launches": plain["counted_launches"]}
    add_launches(out["launches"], run["counted_launches"],
                 graph_launches(dg), plain["counted_launches"])
    ref = run
    del engine, plain
    gc.collect()
    torch.cuda.empty_cache()

    engine = paged_spec_engine(model, draft, SPEC_SAMPLED_STREAMS, True)
    parts, restores = spec_engine_parts(engine, sp)
    try:
        run = engine_run("PagedSampledSpeculativeEngine", engine,
                         prompts[:SPEC_SAMPLED_STREAMS], sampled_req)
    finally:
        for r in restores:
            r()
    dg = spec_graphs("paged sampled draft", engine.d_cache, draft.spec)
    k4 = run["counted_launches"]["paged_attention"]
    if not parts["tail"] or k4 < N_LAYER * len(parts["tail"]):
        fail(f"speculative paged sampled engine: {len(parts['tail'])} tail "
             f"evals, {k4} paged attention launches")
    out["paged_sampled"] = {
        "tokens": run["tokens"], "acceptance": engine.acceptance_rate,
        **engine_summary(run, SPEC_SAMPLED_STREAMS),
        "parts": parts_summary(parts, run, SPEC_SAMPLED_STREAMS),
        "tail_evals": len(parts["tail"]), "k4_launches": k4,
        "graphs": dg, "counted_launches": run["counted_launches"]}
    add_launches(out["launches"], run["counted_launches"],
                 graph_launches(dg))
    del engine, run
    gc.collect()
    torch.cuda.empty_cache()
    return out, ref


def spec_server(model, draft, prompts, ref) -> dict:
    """(vi) LlmServer over PagedSpeculativeEngine: 16 concurrent
    temperature-0 completions, texts equal to (v)'s."""
    from concurrent.futures import ThreadPoolExecutor

    from llm_tpu_torch.server import LlmServer

    engine = paged_spec_engine(model, draft, SERVE_STREAMS)
    rows = record_rows(engine)
    srv = LlmServer(model, engine, host="127.0.0.1", port=0)
    url = "http://%s:%d/v1/completions" % srv.address
    srv.start()
    try:
        srv.warmup()
        rows.clear()
        with all_forwards() as calls:
            zero_launches()
            t0 = time.monotonic()
            with ThreadPoolExecutor(SERVE_STREAMS) as pool:
                results = list(pool.map(lambda p: http_completion(
                    url, {"prompt": p, "max_tokens": SPEC_NEW,
                          "temperature": 0}, exact=False), prompts))
            wall = time.monotonic() - t0
    finally:
        srv.shutdown()
    counted = launches_exact("server", calls)
    errors = [r["finish"] for r in results
              if r["finish"] not in ("length", "stop")]
    if errors:
        fail(f"speculative server: completions failed: {errors}")
    by_prompt = {}
    for rid, rs in rows.items():
        s = engine.finished[rid]
        by_prompt[tuple(s.tokens[: len(s.tokens) - s.generated])] = (
            s.tokens[len(s.tokens) - s.generated:], rs)
    held = []
    for i, (p, r) in enumerate(zip(prompts, results)):
        toks, rs = by_prompt[tuple(p)]
        if [int(x) for x in TOKEN.findall(r["text"])] != \
                [t for t in toks if t != model.eot_token_id()]:
            fail(f"speculative server: request {i}'s text is not its "
                 "stream's tokens")
        held.append(tokens_held(f"server request {i}", toks,
                                ref["tokens"][i], rs, ref["rows"][i]))
    dg = spec_graphs("server draft", engine.d_cache, draft.spec)
    out = {"requests": len(prompts), "wall_s": wall,
           "generated_tok_s": sum(len(by_prompt[tuple(p)][0])
                                  for p in prompts) / wall,
           "tokens_vs_paged_engine": held,
           "acceptance": engine.acceptance_rate,
           "counted_launches": counted, "graphs": dg}
    out["launches"] = dict(counted)
    add_launches(out["launches"], graph_launches(dg))
    del engine, srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def speculative_phase(model, dev, e2e, timer) -> dict:
    """Speculative decoding on the loaded e2e LLaMA-7B (no second load)
    with two drafts: the target itself and a LLaMA-160M-width draft
    written and loaded here (seed 1; freed at the end). With random
    weights these are the two poles of acceptance: the self-draft accepts
    ~every proposal; the 160M draft only proposal 0 (the draft's pick from
    the target's own head logits). Not a realistic acceptance rate."""
    from llm_tpu_torch import loader
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.testing import make_bench_file

    out, part_s = {}, {}
    clock = [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        part_s[name] = now - clock[0]
        clock[0] = now

    path = ROOT / "build" / "smoke" / "llama160m-q4_0.bin"
    try:
        make_bench_file("llama", path, GgmlType.Q4_0, seed=1, n_ff=DRAFT_FF,
                        n_vocab=V, n_embd=DRAFT_E, n_head=DRAFT_H,
                        n_layer=DRAFT_LAYERS, n_mult=256)
        with load_record("speculative_draft"):
            draft = loader.load(path, "llama",
                                params=loader.ModelParameters(
                                    context_size=CTX),
                                device=dev)
    finally:
        path.unlink(missing_ok=True)
    spec = draft.spec
    if (spec.n_embd, spec.n_head, spec.n_layer, spec.n_vocab, spec.n_ctx) \
            != (DRAFT_E, DRAFT_H, DRAFT_LAYERS, V, CTX):
        fail(f"draft spec {spec}")
    ff = draft.params.layers.w_gate_up
    out["draft"] = {"geometry": "JackFram/llama-160m: hidden 768, 12 "
                    "layers, 12 heads of 64, intermediate 3072, vocab "
                    "32000, 2048 positions", "n_ff": ff.r // 2 if ff
                    is not None else None, "format": "Q4_0", "seed": 1}
    lap("draft_load")

    # K1 at the path's new shapes: the 7B target at M = 4 (a verify); the
    # draft (K = 768) at M = 1 (a session step) and 16 (a batched step)
    rng = np.random.default_rng(7)
    out["k1_cases"] = {"target_M4": arch_qmatmul("llama7b", model, rng, dev,
                                                 timer, M=SPEC_K),
                       "draft_M1": arch_qmatmul("llama160m", draft, rng,
                                                dev, timer, M=1),
                       "draft_M16": arch_qmatmul("llama160m", draft, rng,
                                                 dev, timer,
                                                 M=SERVE_STREAMS)}
    lap("k1_cases")

    prompt = e2e_prompts()[1]  # the 64-token prompt
    plain = plain_greedy_rows(model, prompt, SPEC_NEW)
    eot = model.eot_token_id()
    out["plain_vs_e2e"] = e2e_tokens_held(plain[0], prompt,
                                          e2e["runs"][1]["new_ids"], eot)
    out["plain_tokens"] = plain[0]
    launches = {}
    sessions = {}
    for name, d in (("self", model), ("llama160m", draft)):
        sessions[name] = session_run(model, d, prompt, plain, dev)
        add_launches(launches, sessions[name].pop("launches"))
        gc.collect()
        torch.cuda.empty_cache()
    out["session"] = sessions
    lap("sessions")
    out["sampled_session"] = sampled_session_runs(model, prompt)
    add_launches(launches, out["sampled_session"].pop("launches"))
    lap("sampled_session")

    prompts = spec_prompts()
    out["engines"] = dense_engines(model, draft, prompts)
    add_launches(launches, out["engines"].pop("launches"))
    lap("dense_engines")
    paged, ref = paged_engines(model, draft, prompts)
    add_launches(launches, paged.pop("launches"))
    out["engines"].update(paged)
    lap("paged_engines")
    out["server"] = spec_server(model, draft, prompts, ref)
    add_launches(launches, out["server"].pop("launches"))
    lap("server")
    del draft, ref
    gc.collect()
    torch.cuda.empty_cache()
    for k in ("qmatmul", "dense_attention", "paged_attention"):
        if not launches.get(k):
            fail(f"speculative: {k} never launched in the phase")
    out["launches"] = launches
    out["part_s"] = part_s
    sess, eng = out["session"], out["engines"]
    out["summary"] = {
        "session_ms_per_token": {k: v["ms_per_token"]
                                 for k, v in sess.items()},
        "session_wall_ms_per_token": {k: v["wall_ms_per_token"]
                                      for k, v in sess.items()},
        "session_acceptance": {k: v["acceptance"] for k, v in sess.items()},
        "session_tokens_per_round": {k: v["tokens_per_round"]
                                     for k, v in sess.items()},
        "session_launches_per_round": {k: v["launches_per_round"]
                                       for k, v in sess.items()},
        "session_busy_share": {k: v["profile"]["device_busy_share"]
                               for k, v in sess.items()},
        "sampled_session_acceptance": out["sampled_session"]["acceptance"],
        "dense_tok_s": {k: eng["dense"][k]["generated_tok_s"]
                        for k in ("plain", "speculative")},
        "dense_round_ms": eng["dense"]["parts"]["median_ms"],
        "dense_acceptance": eng["dense"]["acceptance"],
        "sampled_engine_acceptance": eng["sampled"][0]["acceptance"],
        "paged_tok_s": {k: eng["paged"][k]["generated_tok_s"]
                        for k in ("plain", "speculative")},
        "paged_round_ms": eng["paged"]["parts"]["median_ms"],
        "paged_verify_profile": eng["paged"]["parts"]["verify_profile"],
        "paged_sampled_k4_launches": eng["paged_sampled"]["k4_launches"],
        "server_tok_s": out["server"]["generated_tok_s"],
        "texts_equal": {
            "sessions": {k: v["tokens_vs_plain"]["equal"]
                         for k, v in sess.items()},
            "dense": sum(r["equal"] for r in eng["dense"]["tokens_vs_plain"]),
            "paged": sum(r["equal"] for r in eng["paged"]["tokens_vs_plain"]),
            "server": sum(r["equal"]
                          for r in out["server"]["tokens_vs_paged_engine"])},
        "launches": launches, "part_s": part_s,
        "note": "random weights: the self-draft is the acceptance pole, the "
                "160M draft the rejection pole; not a realistic rate",
    }
    emit({"speculative_summary": out["summary"]})
    return out


# ---------------------------------------------------------------------------
# phase 4c: the six other architectures


# (name, architecture, format, hparams, n_ff, context, prompt lengths, new
# tokens a prompt, the published layer count). Published widths, and
# bench.py's geometry where it has one (its staged configs #1 GPT-2, #3
# StableLM, #4 MPT; MPT with its published vocab, 50,432, where bench.py
# has 32,000). StableLM rotates a quarter of each head (its published
# rotary_pct; bench.py rotates all of it). The 117M GPT-2 and StableLM-3B
# are whole; MPT-7B keeps 8 of its layers (its Q4_K load and engines took
# 111 s at 32, which the script's time limit cannot spare), GPT-J, BLOOM
# and Falcon keep 4.
ARCH_MODELS = [
    ("mpt7b_q4_k", "mpt", "Q4_K",
     dict(n_vocab=50432, n_embd=4096, n_head=32, n_layer=8,
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
    from llm_tpu_torch.ops import paged_attention as pa

    greedy_prompt_run(model, prompts[0][:4], 2)  # loads the libraries
    zero_launches()
    pa.LAUNCHES_GQA_MMA = 0
    runs = [greedy_prompt_run(model, p, n_new) for p in prompts]
    launches = read_launches()
    gqa = pa.LAUNCHES_GQA_MMA
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
    # the dense cache's launches go through the tensor-core branch exactly
    # where the kv head's query heads do not fit registers (Falcon-7B)
    spec = model.spec
    mma = pa.launch_plan(1, spec.n_head_kv, spec.n_head // spec.n_head_kv,
                         spec.head_dim, 512, 512, torch.bfloat16,
                         num_sms()).mma
    if gqa != (launches["dense_attention"] if mma else 0):
        fail(f"{name} infer: {gqa} launches of the GQA tensor-core branch, "
             f"expected {launches['dense_attention'] if mma else 0}")
    return {"runs": runs, "launches": launches, "gqa_mma_launches": gqa}


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


def arch_qmatmul(name, model, rng, dev, timer, M: int = 1) -> dict:
    """K1 at M rows (default 1, a decode token) on the model's own weights
    (layer 0 of each projection, and the head), held against its plain
    version and timed; the sums of one forward's launches (n_layer x the
    layer's, + the head)."""
    p = model.params
    head = p.lm_head if p.lm_head is not None else p.wte
    L = model.spec.n_layer
    ws = [(f, getattr(p.layers, f).layer(0), L)
          for f in ("w_qkv", "wo", "w_gate_up", "w_up", "w_down")
          if getattr(p.layers, f) is not None] + [("head", head, 1)]
    recs = []
    for f, w, n in ws:
        r = check_qmatmul(f"{name}:{f}", w, M, rng, dev, timer, True)
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

        def load():
            return loader.load(path, arch, params=loader.ModelParameters(
                context_size=ctx), device=dev)

        with load_record(f"archs_{name}") as rec:
            model = load()
        out["load_s"] = rec["load_s"]
        out["load"] = rec
        load_peak = torch.cuda.max_memory_allocated(dev)
        if arch == "mpt":  # the pack cache on the K-quant model
            out["load_parts"] = load_parts(load)
            torch.cuda.reset_peak_memory_stats(dev)  # not the parts' load
            out["pack"] = pack_case(name, path, arch, model, out["load_s"],
                                    ctx, dev)
            # the card's decode against the host's, one whole layer
            out["host_decoded"] = host_decoded_planes(name, model, path,
                                                      arch, dev)
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
    out["peak_bytes"] = max(load_peak, torch.cuda.max_memory_allocated(dev))
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
        name: {"load_s": m["load_s"], "load_parts": m.get("load_parts"),
               "file_bytes": m["file_bytes"],
               "weights_bytes": m["weights_bytes"],
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
        engines_texts_equal=mpt["engines"]["texts_equal"],
        host_decoded=mpt["host_decoded"])
    out["summary"]["kernels"] = {
        "dense_attention_falcon7b": {k: k2[k] for k in (
            "ms", "bound_ms", "plain_ms", "library_ms")},
        "paged_attention_mpt_cell": {k: k4[k] for k in (
            "ms", "bound_ms", "plain_ms", "library_ms")}}
    emit({"archs_summary": out["summary"]})
    return out


# ---------------------------------------------------------------------------
# phase 4i: routes (chat completions, embeddings, engine checkpoints)


ROUTES_STREAMS, ROUTES_PAGES, ROUTES_NEW = 4, 16, 32
ROUTES_EMBED_LENS = (16, 64)
# role strings in the bench vocabulary (its tokens are `<tN>` markers), as
# a request would send its own template
ROUTES_TEMPLATE = {"system": "{content}", "user": "<t11>{content}",
                   "assistant": "<t12>{content}",
                   "generation_prefix": "<t12>", "stop": "<t11>"}
ROUTES_JINJA = ("{% for m in messages %}<t2>{{ m.content }}{% endfor %}"
                "{% if add_generation_prompt %}<t3>{% endif %}")


def serve_prompts(n: int) -> list[list[int]]:
    """The serve phase's first n concurrent prompts (`http_traffic`'s
    draws from the serve phase's seed 4)."""
    rng = np.random.default_rng(4)
    lens = rng.integers(16, 701, SERVE_STREAMS)
    return [rng.integers(1, V, int(k)).tolist() for k in lens][:n]


def as_text(ids) -> str:
    return "".join(f"<t{int(t)}>" for t in ids)


def http_json(url: str, body) -> tuple[int, dict, float]:
    """(status, JSON body, seconds) of one POST, error statuses too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), \
                time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.monotonic() - t0


def http_chat_stream(url: str, body) -> tuple[str, str]:
    """(the content deltas joined, finish reason) of a streamed chat."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    parts, finish = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[6:])
            if chunk["object"] != "chat.completion.chunk":
                fail(f"routes: a chat stream chunk is {chunk['object']}")
            c = chunk["choices"][0]
            parts.append(c["delta"].get("content", ""))
            finish = c["finish_reason"] or finish
    return "".join(parts), finish


def chat_case(base: str, name: str, messages, template, jinja, eot) -> dict:
    """One chat request, non-streamed and streamed, against
    /v1/completions on the prompt `render_chat` gives, with its stop."""
    from llm_tpu_torch.server import render_chat

    prompt, stop = render_chat(messages, template, jinja)
    body = {"messages": messages, "max_tokens": ROUTES_NEW,
            "temperature": 0, "logit_bias": {str(eot): -100}}
    if template is not None:
        body["chat_template"] = template
    status, chat, chat_s = http_json(base + "/v1/chat/completions", body)
    if status != 200 or chat["object"] != "chat.completion":
        fail(f"routes {name}: chat answered {status} {chat}")
    streamed, s_finish = http_chat_stream(base + "/chat/completions", body)
    _, comp, _ = http_json(base + "/v1/completions", {
        "prompt": prompt, "max_tokens": ROUTES_NEW, "temperature": 0,
        "logit_bias": {str(eot): -100}, "stop": [stop]})
    choice, cchoice = chat["choices"][0], comp["choices"][0]
    content = choice["message"]["content"]
    if not (content == streamed.rstrip() == cchoice["text"].rstrip()):
        fail(f"routes {name}: chat {content!r}, streamed {streamed!r}, "
             f"completion {cchoice['text']!r}")
    if not choice["finish_reason"] == s_finish == cchoice["finish_reason"]:
        fail(f"routes {name}: finish reasons {choice['finish_reason']}, "
             f"{s_finish}, {cchoice['finish_reason']}")
    return {"prompt": prompt[:120], "stop": stop,
            "tokens": content.count("<t"), "finish": choice["finish_reason"],
            "content": content[:200], "chat_s": chat_s}


def snapshot_header(path) -> dict:
    import struct

    with open(path, "rb") as f:
        f.read(9)
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n))


def wait_for(cond, timeout: float, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            fail(f"routes: timed out waiting for {what}")
        time.sleep(0.005)


def routes_checkpoint(model, srv, engine, base, d, eot) -> dict:
    """4 greedy streamed completions of the serve phase's prompts, a live
    /admin/checkpoint once every stream has decoded 8 tokens, then the
    streams finish; a fresh engine behind a new LlmServer restores the
    file and its streams finish headless with the same tokens."""
    from concurrent.futures import ThreadPoolExecutor

    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.server import LlmServer

    mid = d / "mid.snap"
    bodies = [{"prompt": p, "max_tokens": ROUTES_NEW, "temperature": 0,
               "logit_bias": {str(eot): -100}, "stream": True}
              for p in serve_prompts(ROUTES_STREAMS)]
    url = base + "/v1/completions"
    with ThreadPoolExecutor(ROUTES_STREAMS) as pool:
        futs = [pool.submit(http_completion, url, b) for b in bodies]

        def decoding():
            live = [s for s in list(engine.slots) if s is not None]
            return len(live) == ROUTES_STREAMS and all(
                not s.prefilling and s.generated >= 8 for s in live)

        wait_for(decoding, 300, "4 decoding streams")
        status, body, write_s = http_json(base + "/admin/checkpoint",
                                          {"path": str(mid)})
        if status != 200:
            fail(f"routes: /admin/checkpoint answered {status} {body}")
        texts = [f.result()["text"] for f in futs]
    header = snapshot_header(mid)
    rids = [s["request_id"] for s in header["streams"]]
    if len(rids) != ROUTES_STREAMS or any(
            s["generated"] >= ROUTES_NEW for s in header["streams"]):
        fail(f"routes: the checkpoint holds {header['streams']!r:.300}")
    want = {rid: list(engine.finished[rid].tokens) for rid in rids}
    status, body, _ = http_json(base + "/admin/checkpoint",
                                {"path": str(ROOT / "build" / "x.snap")})
    if status != 409:
        fail(f"routes: a path outside the snapshot directory got {status}")
    out = {"file_bytes": mid.stat().st_size, "write_s": write_s,
           "generated_at_checkpoint": [s["generated"]
                                       for s in header["streams"]],
           "outside_path_status": status, "texts_tokens": [
               t.count("<t") for t in texts]}

    engine2 = PagedEngine(model, max_streams=ROUTES_STREAMS,
                          page_size=SERVE_PAGE, kv_dtype="int8", n_batch=64,
                          n_pages=ROUTES_PAGES, prefix_cache=True)
    t0 = time.monotonic()
    srv2 = LlmServer(model, engine2, host="127.0.0.1", port=0,
                     engine_snapshot=str(mid))
    torch.cuda.synchronize()
    out["read_s"] = time.monotonic() - t0
    if engine2.active != ROUTES_STREAMS:
        fail(f"routes: the restore holds {engine2.active} streams")
    srv2.start()
    try:
        wait_for(lambda: all(r in engine2.finished for r in rids), 300,
                 "the restored streams")
        got = {rid: list(engine2.finished[rid].tokens) for rid in rids}
    finally:
        srv2.loop.snapshot_path = None  # no final checkpoint of this one
        srv2.shutdown()
    if got != want:
        fail("routes: the restored streams' tokens differ from the "
             "uninterrupted run's")
    out["restored_tokens_equal"] = len(rids)
    mid.unlink()
    return out


def dense_round_trip(model, d, eot) -> dict:
    """`write_engine` / `read_engine` on a dense bf16 engine of 2 slots:
    2 greedy requests (the e2e prompts of 16 and 64 tokens) checkpointed
    with 8 tokens decoded, the original run to its end, a fresh engine
    restored and run: the same tokens."""
    from llm_tpu_torch.engine_snapshot import read_engine, write_engine
    from llm_tpu_torch.samplers import build_sampler_chain
    from llm_tpu_torch.serve import Engine, GenerationRequest

    def make():
        return Engine(model, max_streams=2, kv_dtype=torch.bfloat16,
                      n_batch=64)

    def request(p):
        return GenerationRequest(prompt=p, max_tokens=ROUTES_NEW,
                                 sampler=build_sampler_chain(
                                     ["topk:k=1"],
                                     bias=[(eot, float("-inf"))]))

    path = d / "dense.snap"
    a = make()
    for p in e2e_prompts()[:2]:  # 16 and 64 tokens
        a.submit(request(p))
    while not all(s is not None and not s.prefilling and s.generated >= 8
                  for s in a.slots):
        a.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    write_engine(a, path)
    out = {"write_s": time.monotonic() - t0,
           "file_bytes": path.stat().st_size,
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in (a.cache.k, a.cache.v))}
    while a.has_work():
        a.step()
    want = {r: list(s.tokens) for r, s in a.finished.items()}
    del a
    torch.cuda.empty_cache()
    b = make()
    t0 = time.monotonic()
    read_engine(b, path)
    torch.cuda.synchronize()
    out["read_s"] = time.monotonic() - t0
    while b.has_work():
        b.step()
    got = {r: list(s.tokens) for r, s in b.finished.items()}
    if got != want or len(got) != 2:
        fail("routes: the dense engine's restored tokens differ")
    out["restored_tokens_equal"] = len(got)
    path.unlink()
    del b
    torch.cuda.empty_cache()
    return out


def routes_phase(model, dev) -> dict:
    """The server's chat completions, embeddings and engine checkpoints on
    the e2e LLaMA-7B Q4_0 (already loaded): a paged int8 engine (4 slots,
    page 256, 16 pages, prefix cache) behind
    `LlmServer(engine_snapshot=build/smoke/routes/engine.snap)`.

    (a) /v1/chat/completions, greedy, 32 new tokens, non-streamed and
        streamed: its text equals /v1/completions on the prompt
        `render_chat` gives (with the user prefix as stop), for a
        per-request template, the model's jinja template and the built-in
        default (whose "### Human:" text the bench vocabulary cannot
        tokenize: both routes end with the tokenizer's error).
    (b) /v1/embeddings of a 16- and a 64-token input: 4096 values each,
        within E2E_REL_L2 relative L2 of the same session's under the
        kernels' plain versions; ms an input.
    (c) a live checkpoint mid-decode and a restore in a fresh server
        (`routes_checkpoint`); a path outside the snapshot directory gets
        409; the same round trip through `write_engine` / `read_engine` on
        a dense bf16 engine of 2 slots (`dense_round_trip`).
    Launches are counted from just before the traffic to just after."""
    from llm_tpu_torch.paged import PagedEngine
    from llm_tpu_torch.server import LlmServer
    from llm_tpu_torch.session import (
        InferenceSession,
        InferenceSessionConfig,
        OutputRequest,
    )

    out = {}
    d = ROOT / "build" / "smoke" / "routes"
    d.mkdir(parents=True, exist_ok=True)
    snap = d / "engine.snap"
    snap.unlink(missing_ok=True)
    eot = model.eot_token_id()
    engine = PagedEngine(model, max_streams=ROUTES_STREAMS,
                         page_size=SERVE_PAGE, kv_dtype="int8", n_batch=64,
                         n_pages=ROUTES_PAGES, prefix_cache=True)
    out["pool_bytes"] = engine.pool.nbytes()
    srv = LlmServer(model, engine, host="127.0.0.1", port=0,
                    engine_snapshot=str(snap))
    base = "http://%s:%d" % srv.address
    srv.start()
    try:
        srv.warmup()
        zero_launches()
        rng = np.random.default_rng(17)
        a, b = (as_text(rng.integers(1, V, n)) for n in (8, 24))
        messages = [{"role": "system", "content": a},
                    {"role": "user", "content": b}]
        chat = {"template": chat_case(base, "request template", messages,
                                      ROUTES_TEMPLATE, None, eot)}
        model.chat_template = ROUTES_JINJA
        try:
            chat["model_jinja"] = chat_case(base, "model template", messages,
                                            None, ROUTES_JINJA, eot)
        finally:
            model.chat_template = None
        chat["default"] = chat_case(base, "default template", messages,
                                    None, None, eot)
        if chat["template"]["tokens"] == 0 or \
                chat["model_jinja"]["tokens"] == 0:
            fail("routes: a chat completion generated no token")
        out["chat"] = chat

        inputs = [as_text(rng.integers(1, V, n)) for n in ROUTES_EMBED_LENS]
        emb = []
        for text in inputs:
            status, body, sec = http_json(base + "/v1/embeddings",
                                          {"input": text})
            vec = torch.tensor(body["data"][0]["embedding"])
            if status != 200 or vec.shape != (model.spec.n_embd,):
                fail(f"routes: embeddings answered {status}, "
                     f"{tuple(vec.shape)}")
            with plain_versions(bf16=True):
                sess = InferenceSession(model, InferenceSessionConfig())
                req = OutputRequest(embeddings=[])
                sess.feed_prompt(text, output_request=req)
                del sess
            ref = torch.tensor(req.embeddings[-model.spec.n_embd:])
            rel = float((vec - ref).norm() / ref.norm())
            if rel > E2E_REL_L2 or not bool(torch.isfinite(vec).all()):
                fail(f"routes: an embedding differs from the plain path's: "
                     f"rel L2 {rel:.3g}")
            emb.append({"tokens": text.count("<t"), "ms": 1e3 * sec,
                        "rel_l2_vs_plain": rel,
                        "values": int(vec.numel())})
        out["embeddings"] = emb
        out["checkpoint"] = routes_checkpoint(model, srv, engine, base, d,
                                              eot)
    finally:
        # the final checkpoint on shutdown would write the pool once more
        # (~12 s of zlib); the CPU tests hold it
        srv.loop.snapshot_path = None
        srv.shutdown()
    out["launches_server"] = read_launches()
    del srv, engine
    gc.collect()
    torch.cuda.empty_cache()

    zero_launches()
    out["dense"] = dense_round_trip(model, d, eot)
    out["launches_dense"] = read_launches()
    out["launches"] = {k: out["launches_server"][k] + out["launches_dense"][k]
                       for k in ("qmatmul", "dense_attention",
                                 "paged_attention")}
    for k, v in out["launches"].items():
        if not v:
            fail(f"routes: {k} was not launched")
    out["summary"] = {
        "chat_tokens": {k: c["tokens"] for k, c in out["chat"].items()},
        "chat_finish": {k: c["finish"] for k, c in out["chat"].items()},
        "embedding_ms": [e["ms"] for e in emb],
        "embedding_rel_l2": [e["rel_l2_vs_plain"] for e in emb],
        "paged_checkpoint": {k: out["checkpoint"][k] for k in (
            "file_bytes", "write_s", "read_s", "restored_tokens_equal",
            "outside_path_status")},
        "dense_checkpoint": {k: out["dense"][k] for k in (
            "file_bytes", "cache_bytes", "write_s", "read_s",
            "restored_tokens_equal")},
        "launches": out["launches"],
    }
    emit({"routes_summary": out["summary"]})
    return out


# ---------------------------------------------------------------------------
# phase 4j: adapters (quantize, LoRA, the dense upcast) on GPT-2 117M


# GPT-2 117M at its published geometry (openai-community/gpt2 config.json:
# 768 wide, 12 layers of 12 heads, n_ff 3072, vocab 50257, 1024 positions)
GPT2_HP = dict(n_vocab=50257, n_embd=768, n_head=12, n_layer=12, n_ctx=1024)
GPT2_FF = 3072
ADAPTER_PROMPT, ADAPTER_NEW, ADAPTER_BLOCK = 64, 32, 16
LORA_R, LORA_ALPHA = 8, 16
LORA_TARGETS = ("attn/c_attn/w", "mlp/c_fc/w")
# Each format's error against its f32 source, per block of 32 weights, in
# the block's largest |w|: Q8_0 rounds to steps of d = amax/127 (half a
# step, plus d's own f16 rounding over up to 127 steps: under 0.6 steps);
# Q4_0 steps by d = amax/8 and clamps its top code (one step, plus d's f16
# rounding over 8 steps)
FORMAT_ERR = {"Q8_0": 0.6 / 127, "Q4_0": 1.01 / 8}
QUANTIZED_GPT2 = ("model/wte",) + tuple(
    f"model/h{i}/{t}" for i in range(GPT2_HP["n_layer"])
    for t in ("attn/c_attn/w", "attn/c_proj/w", "mlp/c_fc/w",
              "mlp/c_proj/w"))


def gpt2_weights(model):
    """(file name, the card's weight dequantized as f32 [R, K], the file's
    row order) for every quantized GPT-2 weight."""
    from llm_tpu_torch.models.params import unfuse_layer_weights

    ls = unfuse_layer_weights(model.params.layers)
    parts = {"attn/c_attn/w": (ls.wq, ls.wk, ls.wv), "attn/c_proj/w": (ls.wo,),
             "mlp/c_fc/w": (ls.w_up,), "mlp/c_proj/w": (ls.w_down,)}
    for name in QUANTIZED_GPT2:
        if name == "model/wte":
            yield name, dequant_any(model.params.wte).t()
            continue
        layer, part = int(name.split("/")[1][1:]), name.split("/", 2)[2]
        yield name, torch.cat([dequant_any(w.layer(layer))
                               for w in parts[part]], 1).t()


def planes_within_format(name, model, source, fmt) -> dict:
    """Every quantized weight of the load, dequantized on the card, within
    the format's error (FORMAT_ERR) of the f32 source, block by block."""
    worst = 0.0
    for wname, got in gpt2_weights(model):
        src = torch.from_numpy(np.array(source.fetch_f32(wname))).to(
            got.device)
        blocks = src.reshape(src.shape[0], -1, 32)
        bound = blocks.abs().amax(-1, keepdim=True) * FORMAT_ERR[fmt]
        err = (got.reshape(blocks.shape) - blocks).abs()
        ratio = float((err / bound.clamp_min(1e-30)).amax())
        if not bool((err <= bound).all()):
            fail(f"{name}: {wname} dequantizes {ratio:.3g} x the {fmt} "
                 "error bound from its f32 source")
        worst = max(worst, ratio)
    return {"weights": len(QUANTIZED_GPT2), "max_err_over_bound": worst}


def params_bytes(params) -> int:
    """Bytes of every tensor of a model's parameters (planes or dense)."""
    from dataclasses import fields as dc_fields

    from llm_tpu_torch.ops.packing import QuantTensor, QuantTensorC

    def nbytes(v):
        if isinstance(v, (QuantTensor, QuantTensorC)):
            return plane_bytes(v)
        return v.numel() * v.element_size() if v is not None else 0

    total = sum(nbytes(getattr(params.layers, f.name))
                for f in dc_fields(params.layers))
    return total + sum(nbytes(getattr(params, f.name))
                       for f in dc_fields(params) if f.name != "layers")


def load_gpt2(path, dev, lora=None) -> tuple:
    """(model, load seconds) of a GPT-2 file on the card."""
    from llm_tpu_torch import loader

    with load_record("adapters") as rec:
        model = loader.load(path, "gpt2", params=loader.ModelParameters(
            context_size=GPT2_HP["n_ctx"], lora_adapters=lora), device=dev)
    return model, rec["load_s"]


def lora_planes_equal(model, path, ggla) -> dict:
    """The card's patched planes bit-equal to `LoraAdapter.patch` then
    packing on the host, as the loader packs them: c_attn's thirds fused
    to q|k|v, c_fc alone."""
    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.lora import LoraAdapter
    from llm_tpu_torch.models.params import WeightSource, _thirds
    from llm_tpu_torch.models.spec import get_arch
    from llm_tpu_torch.ops.packing import fuse_quant

    arch = get_arch("gpt2")
    reader = GgmlReader(path).load(
        lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f)))
    ws = WeightSource(reader, "cpu", lora_adapters=[LoraAdapter(ggla)])
    rows = _thirds(GPT2_HP["n_embd"])
    checked = 0
    for i in range(GPT2_HP["n_layer"]):
        p = f"model/h{i}"
        host = {"w_qkv": fuse_quant([ws.matrix(f"{p}/attn/c_attn/w", rows=r)
                                     for r in rows]),
                "w_up": ws.matrix(f"{p}/mlp/c_fc/w")}
        for field, h in host.items():
            card = getattr(model.params.layers, field).layer(i)
            for a, b in zip(card.planes(), h.planes()):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a.cpu(), b)):
                    fail(f"adapters: layer {i} {field}: the card's patched "
                         "planes differ from the host's patch and pack")
            checked += 1
    return {"weights_bit_equal": checked}


def logits_against(name, model, ref_model) -> dict:
    """Teacher-forced first prefill (64 tokens) and decode logits of
    `model` against `ref_model` on the same card: each decoder layer of
    `model` runs on `ref_model`'s input for that layer (`layer_trace`);
    every layer's output and the logits within E2E_REL_L2 relative L2,
    top-1 equal but at a near-tie (`top1_held`)."""
    ids = np.random.default_rng(11).integers(
        1, model.spec.n_vocab, ADAPTER_PROMPT).tolist()
    ref_h, got_h = [], []
    with layer_trace(ref_h) as ref_in:
        pre_r, dec_r = first_logits(ref_model, ids)
    with layer_trace(got_h, ref_in):
        pre_g, dec_g = first_logits(model, ids)
    layer_l2 = [float((g - r).norm() / r.norm())
                for g, r in zip(got_h, ref_h)]
    if max(layer_l2) > E2E_REL_L2:
        fail(f"{name}: a layer's output differs from the reference layer's "
             f"on the same input: rel L2 {max(layer_l2):.3g}")
    out = {"layer_rel_l2_max": max(layer_l2)}
    for part, got, ref in (("prefill", pre_g, pre_r),
                           ("decode", dec_g, dec_r)):
        out[part] = {**compare_logits(f"{name} {part}", got, ref),
                     **top1_held(f"{name} {part}", got, ref)}
    return out


def kernel_category(kernel: str) -> str:
    """A profiled kernel's share of a token: K1 (its two kernels), K2,
    the dense products (cuBLAS's nvjet, gemm or gemv kernels) or the
    rest."""
    low = kernel.lower()
    if "qmm_" in kernel or "sum_splits" in kernel:
        return "qmatmul"
    if ATTN_KERNEL in kernel:
        return "dense_attention"
    if any(s in low for s in ("nvjet", "gemm", "gemv", "cutlass", "xmma")):
        return "dense_products"
    return "rest"


def device_token_ms(model, prompt, rounds: int = 2) -> dict:
    """`infer_device` greedy in blocks of ADAPTER_BLOCK (one graph replay a
    token): ms a token by CUDA events over `rounds` blocks after the
    capture, the profiled split of a block's kernels, and the captures'
    launches."""
    greedy = ds_samplers(model)["greedy"]
    sess = ds_session(model)
    sess.infer_device(prompt, ADAPTER_BLOCK, sampler=greedy,
                      n_steps=ADAPTER_BLOCK, halt_on_eot=False)  # captures

    def block():
        sess.infer_device([], ADAPTER_BLOCK, sampler=greedy,
                          n_steps=ADAPTER_BLOCK, halt_on_eot=False)

    times = [events_ms(block) for _ in range(rounds)]
    prof = step_profile(block, steps=1, split=kernel_category)
    graphs = graph_records(sess)
    del sess
    return {
        "ms_per_token": [d / ADAPTER_BLOCK for d, _ in times],
        "wall_ms_per_token": [w / ADAPTER_BLOCK for _, w in times],
        "split_ms_per_token": {k: v / ADAPTER_BLOCK for k, v in
                               prof["split_ms_per_step"].items()},
        "device_busy_share": prof["device_busy_share"],
        "top_device": prof["top_device"], "graphs": graphs,
    }


def quantize_cli(src, dst, target) -> subprocess.Popen:
    """`python -m llm_tpu_torch quantize -a gpt2 SRC DST TARGET`."""
    return subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch", "quantize", "-a", "gpt2",
         str(src), str(dst), target], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def adapters_phase(dev) -> dict:
    """The quantizer, LoRA adapters and the dense upcast on GPT-2 117M.

    (a) An f32 GPT-2 from seed 0 (the port's `make_tiny_file` at the
        published geometry) is quantized by the cli to Q8_0 and to Q4_0,
        both at once. Each is loaded on the card: every quantized weight
        dequantizes within its format's error of the f32 source, the
        teacher-forced logits (64 tokens, then one decode step) are held
        against the plain path (`arch_logits`), and greedy `infer` gives
        32 tokens after a 64-token prompt with its launches counted
        exactly (`arch_infer`).
    (b) A GGLA adapter from seed 1 (r 8, alpha 16, on every layer's
        attn/c_attn and mlp/c_fc) is applied to the Q8_0 load: the patched
        planes bit-equal to the host's patch and pack, the logits held as
        in (a), load seconds with and without the adapter.
    (c) The Q8_0 file loaded with LLM_TPU_DENSE_UPCAST=1: bf16 dense
        weights; its teacher-forced logits held against the quantized
        load's; weight bytes; device ms a token of the device-sampling
        loop (graph, blocks of 16) beside the quantized load's, in turns,
        and the profiler's split of a token between the dense products,
        K2 and the rest."""
    import os

    from llm_tpu_torch.ggml.reader import GgmlReader
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.models.spec import get_arch
    from llm_tpu_torch.testing import make_lora_file, make_tiny_file

    out = {}
    d = ROOT / "build" / "smoke" / "adapters"
    d.mkdir(parents=True, exist_ok=True)
    src, ggla = d / "gpt2_f32.bin", d / "gpt2_lora.ggla"
    files = {fmt: d / f"gpt2_{fmt.lower()}.bin" for fmt in ("Q8_0", "Q4_0")}
    spec = None
    try:
        t0 = time.monotonic()
        make_tiny_file("gpt2", src, GgmlType.F32, seed=0, n_ff=GPT2_FF,
                       **GPT2_HP)
        out["f32_write_s"] = time.monotonic() - t0
        out["f32_bytes"] = src.stat().st_size
        t0 = time.monotonic()
        procs = {fmt: quantize_cli(src, p, fmt.lower())
                 for fmt, p in files.items()}
        quant = {}
        for fmt, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"adapters: quantize {fmt}: {err[-2000:]}")
            quant[fmt] = {"seconds": time.monotonic() - t0,
                          "bytes": files[fmt].stat().st_size,
                          "summary": err.strip().splitlines()[-1][:200]}
        out["quantize"] = quant
        arch = get_arch("gpt2")
        source = GgmlReader(src).load(
            lambda f: (lambda h: (h, h.n_vocab))(arch.read_hparams(f)))
        rng = np.random.default_rng(3)
        prompt = rng.integers(1, GPT2_HP["n_vocab"], ADAPTER_PROMPT).tolist()
        loads, models = {}, {}
        for fmt, path in files.items():
            model, load_s = load_gpt2(path, dev)
            spec = model.spec
            rec = {"load_s": load_s, "weights_bytes": params_bytes(
                model.params)}
            rec["planes"] = planes_within_format(f"adapters {fmt}", model,
                                                 source, fmt)
            rec["logits"] = arch_logits(f"adapters {fmt}", model)
            rec["infer"] = arch_infer(f"adapters {fmt}", model, [prompt],
                                      ADAPTER_NEW)
            loads[fmt] = rec
            models[fmt] = model
        del models["Q4_0"], model
        out["loads"] = loads

        # (b) LoRA on the Q8_0 file
        names = [f"model/h{i}/{t}" for i in range(GPT2_HP["n_layer"])
                 for t in LORA_TARGETS]
        shapes = {n: tuple(source.tensors[n].dims) for n in names}
        make_lora_file(ggla, names, shapes, LORA_R, LORA_ALPHA, seed=1)
        lora_model, lora_s = load_gpt2(files["Q8_0"], dev, [str(ggla)])
        out["lora"] = {
            "r": LORA_R, "alpha": LORA_ALPHA, "tensors": len(names),
            "load_s": lora_s, "load_s_without": loads["Q8_0"]["load_s"],
            **lora_planes_equal(lora_model, files["Q8_0"], ggla),
            "logits": arch_logits("adapters lora", lora_model),
            "infer": arch_infer("adapters lora", lora_model, [prompt],
                                ADAPTER_NEW),
        }
        if out["lora"]["infer"]["runs"][0]["new_ids"] == \
                loads["Q8_0"]["infer"]["runs"][0]["new_ids"]:
            fail("adapters: the LoRA load gives the base model's tokens")
        del lora_model, source

        # (c) the dense upcast of the Q8_0 file
        os.environ["LLM_TPU_DENSE_UPCAST"] = "1"
        try:
            up_model, up_s = load_gpt2(files["Q8_0"], dev)
        finally:
            del os.environ["LLM_TPU_DENSE_UPCAST"]
        q8 = models.pop("Q8_0")
        if not isinstance(up_model.params.layers.wq, torch.Tensor) or \
                up_model.params.layers.wq.dtype != torch.bfloat16:
            fail("adapters: the upcast load holds no bf16 dense weights")
        upcast = {"load_s": up_s,
                  "weights_bytes": params_bytes(up_model.params),
                  "quantized_weights_bytes": loads["Q8_0"]["weights_bytes"],
                  "logits_vs_quantized": logits_against(
                      "adapters upcast", up_model, q8)}
        from llm_tpu_torch.ops import qmatmul as qm

        runs = {"quantized": [], "upcast": []}
        for which in ("quantized", "upcast", "upcast", "quantized"):
            runs[which].append(device_token_ms(
                q8 if which == "quantized" else up_model, prompt))
        upcast["mm_out_dtype"] = qm.MM_OUT_DTYPE
        for which, rs in runs.items():
            upcast[which] = {
                "ms_per_token": [m for r in rs for m in r["ms_per_token"]],
                "wall_ms_per_token": [m for r in rs
                                      for m in r["wall_ms_per_token"]],
                "split_ms_per_token": rs[-1]["split_ms_per_token"],
                "device_busy_share": rs[-1]["device_busy_share"],
                "top_device": rs[-1]["top_device"],
            }
        graphs = {w: [g for r in rs for g in r["graphs"]]
                  for w, rs in runs.items()}
        launches_held("adapters quantized device loop", graphs["quantized"],
                      spec)
        want_up = {"qmatmul": 0, "dense_attention": spec.n_layer,
                   "paged_attention": 0}
        for g in graphs["upcast"]:
            if g["launches_per_replay"] != want_up:
                fail(f"adapters upcast: a capture counted "
                     f"{g['launches_per_replay']} launches, not {want_up}")
        out["upcast"] = upcast
        out["graphs"] = graphs
        del up_model, q8
    finally:
        for p in (src, ggla, *files.values()):
            p.unlink(missing_ok=True)
    counted = [r["infer"]["launches"] for r in (*loads.values(),
                                                out["lora"])]
    out["launches"] = {
        k: sum(c[k] for c in counted) + sum(
            g["launches_per_replay"][k] * g["replays"]
            for gs in out["graphs"].values() for g in gs)
        for k in ("qmatmul", "dense_attention", "paged_attention")}
    for k in ("qmatmul", "dense_attention"):
        if not out["launches"][k]:
            fail(f"adapters: {k} was not launched")
    gc.collect()
    torch.cuda.empty_cache()
    up = out["upcast"]
    out["summary"] = {
        "quantize_s": {f: q["seconds"] for f, q in quant.items()},
        "quantize_bytes": {f: q["bytes"] for f, q in quant.items()},
        "load_s": {f: r["load_s"] for f, r in loads.items()},
        "max_err_over_bound": {f: r["planes"]["max_err_over_bound"]
                               for f, r in loads.items()},
        "logits_rel_l2": {f: [r["logits"][p]["rel_l2"]
                              for p in ("prefill", "decode")]
                          for f, r in loads.items()},
        "lora_load_s": out["lora"]["load_s"],
        "lora_logits_rel_l2": [out["lora"]["logits"][p]["rel_l2"]
                               for p in ("prefill", "decode")],
        "upcast_weights_bytes": up["weights_bytes"],
        "quantized_weights_bytes": up["quantized_weights_bytes"],
        "upcast_logits_rel_l2_vs_quantized": [
            up["logits_vs_quantized"][p]["rel_l2"]
            for p in ("prefill", "decode")],
        "device_ms_per_token": {w: up[w]["ms_per_token"]
                                for w in ("quantized", "upcast")},
        "split_ms_per_token": {w: up[w]["split_ms_per_token"]
                               for w in ("quantized", "upcast")},
        "mm_out_dtype": up["mm_out_dtype"],
        "launches": out["launches"],
    }
    emit({"adapters_summary": out["summary"]})
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


# M of the probe cuts' checks and of P2's runs: a serving step and a
# decode token on K1's swapped path at 8 tokens a block, a prompt chunk on
# its wide path at 256
PROBE_MS = (8, 1, 512)


def probe_checks(dev) -> list[dict]:
    """Every P2 stage (a cut of K1 on its plan at M = 1, 8 and 512), P3
    mode and P1 variant against its plain version at K=1024, R=512, layer
    1 of a 2-layer stack, over Q4_0, Q8_0 and Q6_K where the variant takes
    the format."""
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

    def stage_rec(probe, case, layout, w, stage, m=M):
        return held(probe, case, layout, qp.stage_run(w, stage, m),
                    qp.stage_plain(w, stage), stage_rule(stage), w, M=m)

    # P2 stages (and P1/P3's stream) over planes and coalesced buffers
    for t in (GgmlType.Q4_0, GgmlType.Q8_0, GgmlType.Q6_K):
        st = stacked(t)
        sc = packing.coalesce_qt(st, 512, 128)  # 2 k-tiles, 4 r-tiles
        for stage in qp.STAGES:
            for m in PROBE_MS:
                recs.append(stage_rec("P2", stage, "planes", st.layer(1),
                                      stage, m))
                recs.append(stage_rec("P2", stage, "coalesced", sc.layer(1),
                                      stage, m))
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
    at M = 8, 1 and 512; P3 over 4096 x 11008 coalesced whole K x 512 lanes; P1
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
    for M in PROBE_MS:
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
        **{f"P2_M{m}": (lambda m=m: p2.run(dev, M=m, rounds=3))
           for m in PROBE_MS},
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
    variant (P1: the stream cut over coalesce_tiles' own tiling, the
    kernel `make_stream_chain` built; P2: the stream cut at M=8; P3: base):
    device time a launch at 7B from the probe's run, the bound of that
    launch (its inputs read once: the packed weight and x as the kernel
    takes it, f32 on the swapped path; its output written once), and the
    plain version's and one torch.matmul's time on one layer of the same
    weight (bf16, the same [M, K] x [K, R] shape). `max_abs_err` is the
    headline variant's largest over its checks (small and 7B shapes);
    `checks` counts all of the probe's. P2's entry also carries its rows at
    M = 1 and 512 (the wide path)."""
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
                  w1.buf.numel() * 4 + M * w1.k * 4 + w1.rp * 4, 0.0,
                  lambda: qp.stage_plain(w1, "stream"),
                  matmul(w1.k, w1.r)))
    w2 = common.random_q4_0(4096, 4096, 0, dev)
    specs.append(("probe_kernel_decompose", "P2", probes["P2_M8"], "stream",
                  "scripts/probe_kernel_decompose.py:108",
                  (w2.lo.numel() + w2.scale.numel()) * 4 + M * w2.k * 4
                  + w2.r_padded * 4,
                  0.0, lambda: qp.stage_plain(w2, "stream"),
                  matmul(w2.k, w2.r)))
    w3 = p3.build(p3.K, p3.R, 0, dev)
    x3 = x_of(w3.k)
    specs.append(("probe_dequant_variants", "P3", probes["P3"], "base",
                  "scripts/probe_dequant_variants.py:221",
                  w3.buf.numel() * 4 + M * w3.k * 4 + M * w3.r * 4,
                  2.0 * M * w3.k * w3.r,
                  lambda: qp.mode_plain(x3, w3, "base"),
                  matmul(w3.k, w3.r)))
    for name, tag, res, variant, rep, n_bytes, flops, plain, lib in specs:
        rows = res.get("variants") or res.get("modes")
        b, by = bound_ms(n_bytes, flops)
        launches = sum(res["launches_counted"].values())
        e = {
            "name": name, "route": "cuda",
            "source": "llm_tpu_torch/csrc/qmatmul_probe.cu",
            "source_also": ["llm_tpu_torch/csrc/qmatmul_tc.cuh"],
            "replaces": rep, "launches": launches,
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
        }
        if tag == "P2":
            for m in PROBE_MS[1:]:
                r = probes[f"P2_M{m}"]
                e["launches"] += sum(r["launches_counted"].values())
                e[f"variants_us_M{m}"] = {n: d["us"] for n, d in
                                          r["variants"].items()}
                e[f"variants_kernel_us_M{m}"] = {
                    n: d["kernel_us"] for n, d in r["variants"].items()}
        out.append(e)
    return out


# ---------------------------------------------------------------------------


def step_by_m(recs) -> dict:
    """Per M, times of one 7B step's launches (qkv, wo, gate_up, down x 32
    layers, lm_head once where `recs` has it): the call's ms, bound, plain
    and torch.matmul ms from `recs`."""
    per = {"qkv": N_LAYER, "wo": N_LAYER, "gate_up": N_LAYER,
           "down": N_LAYER, "lm_head": 1}
    out = {}
    for M in sorted({r["M"] for r in recs if r["case"] in per}):
        rs = [r for r in recs if r["M"] == M and r["case"] in per]
        cases = {r["case"] for r in rs}
        row = {k: sum(r[k] * per[r["case"]] for r in rs)
               for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
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


# ---------------------------------------------------------------------------
# phase 3c: the pack cache (models/pack_cache.py)


def leaves_equal(name, a, b,
                 what: str = "the warm load differs from the cold load's"
                 ) -> int:
    """Every tensor leaf of two parameter trees (or tuples of them)
    bit-equal (same dtype and shape); returns the number of leaves
    compared."""
    from dataclasses import fields

    from llm_tpu_torch.ops.packing import QuantTensor, QuantTensorC

    def leaves(obj, out):
        if isinstance(obj, torch.Tensor):
            out.append(obj)
        elif isinstance(obj, tuple):
            for x in obj:
                leaves(x, out)
        elif isinstance(obj, QuantTensor):
            for p in obj.planes():
                leaves(p, out)
        elif isinstance(obj, QuantTensorC):
            out.append(obj.buf)
        elif obj is not None and hasattr(obj, "__dataclass_fields__"):
            for f in fields(obj):
                leaves(getattr(obj, f.name), out)
        return out

    la, lb = leaves(a, []), leaves(b, [])
    if len(la) != len(lb) or not la:
        fail(f"{name}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                bits(x), bits(y)):
            fail(f"{name}: leaf {i}: {what}")
    return len(la)


def pack_case(name, path, arch, model, cold_s, ctx, dev) -> dict:
    """`llm-tpu-torch pack`'s work on a loaded model: write the pack next
    to `path`, load the file again (the transcode forbidden, so the load
    must come from the pack), hold every plane bit-equal to the cold
    load's, and remove the pack."""
    import shutil

    from llm_tpu_torch import loader
    from llm_tpu_torch.models.pack_cache import (
        cache_key,
        pack_path,
        save_packed_params,
    )

    pp = pack_path(path)
    shutil.rmtree(pp, ignore_errors=True)
    t_start = time.monotonic()
    build = loader.build_params

    def forbidden(ws, spec):
        fail(f"{name}: the warm load transcoded despite the pack")

    try:
        t0 = time.monotonic()
        save_packed_params(model.params, pp, cache_key(path))
        write_s = time.monotonic() - t0
        n_bytes = sum(f.stat().st_size for f in pp.iterdir())
        loader.build_params = forbidden
        with load_record(f"pack_{name}") as rec:
            warm = loader.load(path, arch,
                               params=loader.ModelParameters(
                                   context_size=ctx),
                               device=dev)
        warm_s = rec["load_s"]
    finally:
        loader.build_params = build
        shutil.rmtree(pp, ignore_errors=True)
    leaves = leaves_equal(name, model.params, warm.params)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    return {"cold_load_s": cold_s, "write_s": write_s, "pack_bytes": n_bytes,
            "warm_load_s": warm_s, "leaves_bit_equal": leaves,
            "seconds": time.monotonic() - t_start}


# ---------------------------------------------------------------------------
# phase 3d: parallelism (parallel/), worlds of 2 ranks on the one card


PAR_WORLD = 2
PAR_PROMPT, PAR_DECODE = 64, 16  # the teacher-forced TP run
PAR_ENGINE_PROMPTS, PAR_ENGINE_NEW = 4, 16
PAR_ENGINE_CUT = 64  # tokens of each serve prompt the engines take (one chunk)
PAR_MULTI_NEW = 8  # tokens a stream of the multi-step run, in 2 blocks
PAR_PIPE_STREAMS, PAR_PIPE_MICRO, PAR_PIPE_T = 4, 2, 16
PAR_TIMEOUT = 300  # s a world may run before it is killed
# the engines under a mesh: TP (1, 2) dense bf16 and paged int8, and the
# dense engine over (data, model) = (2, 1)
PAR_ENGINES = ("dense", "paged", "dense_dp")
NCCL_LAYERS = 2


def rank_timer_ms(fn, iters: int = 10) -> float:
    """Median wall ms of fn() with the card synchronized around each run
    (a collective staged through the host is timed with its copies)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def teacher_forced(model, params, cache, ids, tokens, trace=None,
                   inputs=None):
    """The prompt's last logits and the logits of len(tokens) decode steps
    fed `tokens` (forced, not sampled), as [1 + n, V]; with `trace` each
    layer's output is recorded (`layer_trace`), with `inputs` each layer
    runs on the recorded input of another run."""
    from llm_tpu_torch.models.forward import forward_step, window_bucket

    spec = model.spec
    ctx = (layer_trace(trace, inputs) if trace is not None
           else contextlib.nullcontext([]))
    with ctx as seen:
        rows = [forward_step(spec, params, torch.tensor(ids), 0, cache,
                             window_bucket(0, spec.n_ctx))[0][-1]]
        for i, t in enumerate(tokens):
            n = len(ids) + i
            rows.append(forward_step(spec, params, torch.tensor([t]), n,
                                     cache, window_bucket(n, spec.n_ctx))
                        [0][-1])
    return torch.stack(rows).float(), seen


def held_forced(name, model, run_ref, run_got) -> dict:
    """`run_got`'s logits against `run_ref`'s (each a function of (trace,
    inputs) -> logits): free running (only the tokens forced) within
    E2E_REL_L2 with top-1 equal; where they diverge, layer by layer with
    each layer on the reference's input for it (the random 7B is chaotic,
    ROADMAP C), every layer and the logits within E2E_REL_L2."""
    ref_h = []
    ref, ref_in = run_ref(ref_h, None)
    got, _ = run_got(None, None)
    free = float((got - ref).norm() / ref.norm())
    out = {"rows": int(ref.shape[0]), "free_rel_l2": free,
           "free_top1_agree": float((got.argmax(-1) == ref.argmax(-1))
                                    .float().mean())}
    if free <= E2E_REL_L2:
        out["held"] = "free"
        out.update(top1_held(name, got, ref))
        return out
    got_h = []
    forced, _ = run_got(got_h, ref_in)
    layer = [float((g - r).norm() / r.norm()) for g, r in zip(got_h, ref_h)]
    out.update(held="layer_forced", layer_rel_l2_max=max(layer),
               **compare_logits(name, forced, ref),
               **top1_held(name, forced, ref))
    if max(layer) > E2E_REL_L2:
        fail(f"{name}: a layer differs: rel L2 {max(layer):.3g}")
    return out


def par_engine_texts(model, mesh, prompts, kind, dev) -> dict:
    """One engine over `mesh` on the prompts, greedy, PAR_ENGINE_NEW new
    tokens each; its launches counted (counters zeroed just before, read
    just after) and held exactly to the forwards it ran."""
    from llm_tpu_torch import paged as paged_mod
    from llm_tpu_torch import serve as serve_mod
    from llm_tpu_torch.samplers import GreedySampler

    if kind == "paged":
        engine = paged_mod.PagedEngine(
            model, max_streams=len(prompts), page_size=SERVE_PAGE,
            kv_dtype="int8", n_batch=64, mesh=mesh)
        module, fn, attention = paged_mod, "paged_forward_batched", \
            "paged_attention"
    else:
        engine = serve_mod.Engine(model, max_streams=len(prompts),
                                  kv_dtype=torch.bfloat16, n_batch=64,
                                  mesh=mesh)
        module, fn, attention = serve_mod, "forward_batched", \
            "dense_attention"
    reqs = [serve_mod.GenerationRequest(prompt=p, max_tokens=PAR_ENGINE_NEW,
                                        sampler=GreedySampler())
            for p in prompts]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.monotonic()
    with counted_forwards(module, fn) as counts:
        got = engine.generate_all(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    check_engine_launches(f"{kind} engine under a mesh", launches,
                          dict(counts), attention, model.spec)
    slots = engine.cache.k.shape[1] if kind == "dense" else None
    del engine
    torch.cuda.empty_cache()
    return {"texts": [got[i] for i in sorted(got)], "launches": launches,
            "forwards": dict(counts), "wall_s": wall, "cache_slots": slots}


def parallel_rank(rank, world, path, device) -> dict:
    """One rank of the gloo world of 2 on the one card: TP over
    ("data", "model") = (1, 2), the GPipe pipeline over 2 stages and the
    ring prefill over 2 ranks, each held against the single-card forward
    of the same weights (which every rank loads whole from the file)."""
    from llm_tpu_torch import loader
    from llm_tpu_torch.models import forward as fwd
    from llm_tpu_torch.parallel import collectives_audit as audit
    from llm_tpu_torch.parallel import pipeline as pp
    from llm_tpu_torch.parallel import ring
    from llm_tpu_torch.parallel import sharding as sh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": rank}
    t0 = time.monotonic()
    model = loader.load(path, "llama",
                        params=loader.ModelParameters(context_size=CTX),
                        device=dev)
    spec = model.spec
    out["load_s"] = time.monotonic() - t0
    mesh = sh.make_mesh(sh.MeshConfig(data=1, model=world), device=dev)
    t0 = time.monotonic()
    params = sh.shard_params(model.params, mesh, spec)
    torch.cuda.synchronize()
    out["shard_s"] = time.monotonic() - t0
    tp = params.tp
    out["layout"] = {"attn": tp.attn, "wo_split": tp.wo_split,
                     "ffn": tp.ffn, "vocab": tp.vocab,
                     "n_head": tp.n_head, "n_head_kv": tp.n_head_kv,
                     "wqkv_r": params.layers.w_qkv.r,
                     "wo_k": params.layers.wo.k,
                     "w_gate_up_r": params.layers.w_gate_up.r,
                     "w_down_k": params.layers.w_down.k,
                     "lm_head_r": params.lm_head.r}
    if not (tp.attn and tp.wo_split and tp.ffn and tp.vocab):
        fail(f"rank {rank}: LLaMA-7B did not shard fully: {out['layout']}")

    # (a) TP, teacher forced: the prompt, then PAR_DECODE forced tokens
    ids = e2e_prompts()[1][:PAR_PROMPT]
    tokens = np.random.default_rng(7).integers(1, V, PAR_DECODE).tolist()

    def single(trace, inputs):
        cache = fwd.init_cache(spec, torch.bfloat16, dev)
        return teacher_forced(model, model.params, cache, ids, tokens,
                              trace, inputs)

    def sharded(trace, inputs):
        cache = sh.shard_cache(fwd.init_cache(spec, torch.bfloat16, dev),
                               mesh)
        return teacher_forced(model, params, cache, ids, tokens, trace,
                              inputs)

    out["tp_logits"] = held_forced(f"rank {rank} tp", model, single, sharded)

    # one decode forward: launches, ms a token, the audit's bytes
    cache = sh.shard_cache(fwd.init_cache(spec, torch.bfloat16, dev), mesh)
    fwd.forward_step(spec, params, torch.tensor(ids), 0, cache)

    def step():
        return fwd.forward_step(spec, params, torch.tensor([tokens[0]]),
                                len(ids), cache, 512)

    torch.cuda.synchronize()
    zero_launches()
    step()
    torch.cuda.synchronize()
    one = read_launches()
    if one["qmatmul"] != 4 * N_LAYER + 1 or one["dense_attention"] != \
            N_LAYER or one["paged_attention"]:
        fail(f"rank {rank}: one TP decode forward launched {one}")
    out["decode_launches"] = one
    out["tp_ms_per_token"] = rank_timer_ms(step)
    single_cache = fwd.init_cache(spec, torch.bfloat16, dev)
    fwd.forward_step(spec, model.params, torch.tensor(ids), 0, single_cache)
    out["single_ms_per_token"] = rank_timer_ms(
        lambda: fwd.forward_step(spec, model.params,
                                 torch.tensor([tokens[0]]), len(ids),
                                 single_cache, 512))
    del single_cache
    res = audit.audit_step(step, mesh)
    out["audit"] = {"bytes_by_axis": res.bytes_by_axis, "ops": len(res.ops),
                    "table": res.table()}
    want = {"model": 2 * N_LAYER * E * 4 + V * 4}
    if res.bytes_by_axis != want:
        fail(f"rank {rank}: audit {res.bytes_by_axis}, expected {want}")
    x_red = torch.randn((1, E), device=dev)
    x_gat = torch.randn((1, V // world), device=dev)
    out["collective_ms"] = {
        "all_reduce_1x4096_f32": rank_timer_ms(
            lambda: sh.all_reduce(x_red, mesh, "model"), 50),
        "all_gather_1x16000_f32": rank_timer_ms(
            lambda: sh.all_gather(x_gat, mesh, "model"), 50)}
    timer = Timer(dev)
    k1 = {}
    layer0 = params.layers.layer(0)
    for name, w in (("qkv", layer0.w_qkv), ("wo", layer0.wo),
                    ("gate_up", layer0.w_gate_up), ("down", layer0.w_down),
                    ("lm_head", params.lm_head)):
        x = torch.randn((1, w.k), device=dev)
        k1[name] = timer.ms(lambda: fwd.qmatmul(x, w))
    del timer
    k1["per_token"] = N_LAYER * (k1["qkv"] + k1["wo"] + k1["gate_up"]
                                 + k1["down"]) + k1["lm_head"]
    out["k1_ms"] = k1
    del cache
    torch.cuda.empty_cache()

    # (b) the dense bf16 and the paged int8 engine under the mesh
    # each collective is staged through the host, so a rank's eager
    # forward costs ~3x a single card's: the prompts are cut to one chunk
    prompts = [p[:PAR_ENGINE_CUT] for p in serve_prompts(PAR_ENGINE_PROMPTS)]
    out["engines"] = {kind: par_engine_texts(model, mesh, prompts, kind, dev)
                      for kind in ("dense", "paged")}
    # the dense engine over ("data", "model") = (2, 1): a rank's cache
    # holds its one slot of the two and computes that stream
    dmesh = sh.make_mesh(sh.MeshConfig(data=world, model=1), device=dev)
    dp = par_engine_texts(model, dmesh, prompts[:world], "dense", dev)
    if dp["cache_slots"] != 1:
        fail(f"rank {rank}: the data=2 engine's cache holds "
             f"{dp['cache_slots']} slots")
    out["engines"]["dense_dp"] = dp
    # multi-step blocks under the mesh: each block's graph runs eagerly,
    # counted once a block in forward.EAGER_UNDER_MESH
    from llm_tpu_torch.ops.sampling import DeviceSampler
    from llm_tpu_torch.serve import Engine, GenerationRequest

    eng = Engine(model, max_streams=2, kv_dtype=torch.bfloat16, n_batch=64,
                 mesh=mesh)
    before = fwd.EAGER_UNDER_MESH
    multi = eng.generate_all(
        [GenerationRequest(prompt=p, max_tokens=PAR_MULTI_NEW,
                           device_sampler=DeviceSampler.greedy())
         for p in prompts[:2]], n_steps=PAR_MULTI_NEW // 2)
    eager = fwd.EAGER_UNDER_MESH - before
    if eager != eng.multi_blocks or not eager:
        fail(f"rank {rank}: {eager} eager blocks for {eng.multi_blocks}")
    out["multi_step"] = {"texts": [multi[i] for i in sorted(multi)],
                         "blocks": eng.multi_blocks,
                         "eager_under_mesh": eager}
    del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the pipeline: 2 stages of 16 layers, 2 microbatches of 2 streams
    pmesh = pp.make_pipeline_mesh(pipe=world, device=dev)
    stage = pp.shard_params_pipeline(model.params, pmesh)
    rng = np.random.default_rng(17)
    B, T = PAR_PIPE_STREAMS, PAR_PIPE_T
    pids = torch.as_tensor(rng.integers(1, V, (B, T)))
    nxt = torch.as_tensor(rng.integers(1, V, (B, 1)))
    ref_cache = fwd.init_cache_batched(spec, B, torch.bfloat16, dev)
    ref_pre = fwd.forward_batched(spec, model.params, pids, [0] * B,
                                  ref_cache, 512)[0]
    ref_dec = fwd.forward_batched(spec, model.params, nxt, [T] * B,
                                  ref_cache, 512)[0]
    cache = pp.shard_cache_pipeline(
        fwd.init_cache_batched(spec, B, torch.bfloat16, dev), pmesh)
    zero_launches()
    got_pre = pp.pipeline_forward_batched(spec, stage, pids, [0] * B, cache,
                                          pmesh, PAR_PIPE_MICRO, 512)[0]
    got_dec = pp.pipeline_forward_batched(spec, stage, nxt, [T] * B, cache,
                                          pmesh, PAR_PIPE_MICRO, 512)[0]
    torch.cuda.synchronize()
    plaunch = read_launches()
    # a stage runs its 16 layers' 4 projections for each microbatch of
    # each forward, the last stage also the head; K2 on the decode step
    per_stage = 4 * N_LAYER // world * PAR_PIPE_MICRO * 2
    last = pmesh.coords["pipe"] == world - 1
    want_k1 = per_stage + (2 if last else 0)
    if plaunch["qmatmul"] != want_k1 or plaunch["dense_attention"] != \
            N_LAYER // world * PAR_PIPE_MICRO:
        fail(f"rank {rank}: pipeline launches {plaunch}, expected qmatmul "
             f"{want_k1}")
    out["pipeline"] = {
        "prefill": compare_logits(f"rank {rank} pipeline prefill",
                                  got_pre, ref_pre),
        "decode": compare_logits(f"rank {rank} pipeline decode", got_dec,
                                 ref_dec),
        "launches": plaunch}
    out["pipeline"]["prefill"].update(top1_held("pipeline prefill",
                                                got_pre, ref_pre))
    out["pipeline"]["decode"].update(top1_held("pipeline decode", got_dec,
                                               ref_dec))
    del stage, cache, ref_cache
    torch.cuda.empty_cache()

    # (d) the ring prefill of the 1100-token prompt over 2 ranks
    smesh = ring.make_seq_mesh(world, device=dev)
    rids = torch.tensor([e2e_prompts()[2]])
    Tn = rids.shape[1]
    ref_cache = fwd.init_cache_batched(spec, 1, torch.bfloat16, dev)
    ref_last = fwd.forward_batched(spec, model.params, rids, [0], ref_cache)[
        0][:, -1]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.monotonic()
    last, rcache = ring.ring_prefill(spec, model.params, rids, smesh,
                                     kv_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rlaunch = read_launches()
    if rlaunch["qmatmul"] != 4 * N_LAYER + (1 if smesh.coords["seq"]
                                            == world - 1 else 0):
        fail(f"rank {rank}: ring launches {rlaunch}")
    out["ring"] = {
        "wall_s": time.monotonic() - t0, "launches": rlaunch,
        "last_logits": {**compare_logits(f"rank {rank} ring", last,
                                         ref_last),
                        **top1_held("ring", last, ref_last)},
        "k_rel_l2": float((rcache.k[:, :, :, :Tn].float()
                           - ref_cache.k[:, :, :, :Tn].float()).norm()
                          / ref_cache.k[:, :, :, :Tn].float().norm()),
        "v_rel_l2": float((rcache.v[:, :, :, :Tn].float()
                           - ref_cache.v[:, :, :, :Tn].float()).norm()
                          / ref_cache.v[:, :, :, :Tn].float().norm())}
    for key in ("k_rel_l2", "v_rel_l2"):
        if out["ring"][key] > E2E_REL_L2:
            fail(f"rank {rank}: ring cache {key} {out['ring'][key]:.3g}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def nccl_rank(rank, world, path, device) -> dict:
    """A world of one on nccl: TP over a (1, 1) mesh of the 2-layer
    full-width model, held against its unsharded forward; its collectives
    run on NCCL."""
    from llm_tpu_torch import loader
    from llm_tpu_torch.models import forward as fwd
    from llm_tpu_torch.parallel import collectives_audit as audit
    from llm_tpu_torch.parallel import sharding as sh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    model = loader.load(path, "llama",
                        params=loader.ModelParameters(context_size=CTX),
                        device=dev)
    spec = model.spec
    mesh = sh.make_mesh(sh.MeshConfig(1, 1), device=dev)
    params = sh.shard_params(model.params, mesh, spec)
    ids = e2e_prompts()[0]
    tokens = [int(t) for t in np.random.default_rng(5).integers(1, V, 2)]

    def run(p):
        cache = fwd.init_cache(spec, torch.bfloat16, dev)
        return teacher_forced(model, p, cache, ids, tokens)[0]

    ref = run(model.params)
    res = audit.audit_step(lambda: run(params), mesh)
    zero_launches()
    got = run(params)
    launches = read_launches()
    forwards = 1 + len(tokens)
    if launches["qmatmul"] != (4 * NCCL_LAYERS + 1) * forwards or \
            launches["dense_attention"] != NCCL_LAYERS * len(tokens):
        fail(f"nccl: launches {launches}")
    ops = {}
    for o in res.ops:
        ops[o.op] = ops.get(o.op, 0) + 1
    if ops != {"all-reduce": 2 * NCCL_LAYERS * forwards,
               "all-gather": forwards}:
        fail(f"nccl: collectives {ops}")
    return {"backend": mesh.backend, "logits": compare_logits("nccl", got,
                                                             ref),
            "collectives": ops, "bytes_by_axis": res.bytes_by_axis,
            "launches": launches}


def parallel_phase(dev) -> dict:
    """A gloo world of 2 ranks on the one card (`parallel_rank`) over the
    e2e LLaMA-7B Q4_0 file at full width and depth, then a world of one
    on nccl over a 2-layer full-width model (`nccl_rank`). The kernels
    are built (main), so the ranks only load them. The two ranks share one
    card's bandwidth and its collectives are staged through the host: its
    times are not a multi-GPU speed."""
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.parallel import launch
    from llm_tpu_torch.testing import make_bench_file

    out = {}
    store = ROOT / "build" / "smoke" / "parallel"
    import shutil

    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    t0 = time.monotonic()
    ranks = launch.spawn(parallel_rank, PAR_WORLD, "gloo", store / "gloo",
                         timeout=PAR_TIMEOUT,
                         args=(str(bench_path()), str(dev)))
    out["gloo_world_s"] = time.monotonic() - t0
    for kind in PAR_ENGINES:
        toks = [r["engines"][kind]["texts"] for r in ranks]
        if any(t != toks[0] for t in toks[1:]):
            fail(f"parallel: the {kind} engine's texts differ by rank")
    if ranks[0]["multi_step"]["texts"] != ranks[1]["multi_step"]["texts"]:
        fail("parallel: the multi-step texts differ by rank")
    out["ranks"] = ranks
    small = store / "llama7b-2layer.bin"
    try:
        make_bench_file("llama", small, GgmlType.Q4_0, seed=0, n_ff=FF,
                        n_vocab=V, n_embd=E, n_head=H, n_layer=NCCL_LAYERS,
                        n_mult=256)
        t0 = time.monotonic()
        out["nccl"] = launch.spawn(nccl_rank, 1, "nccl", store / "nccl",
                                   timeout=PAR_TIMEOUT,
                                   args=(str(small), str(dev)))[0]
        out["nccl_world_s"] = time.monotonic() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    if out["nccl"]["backend"] != "nccl":
        fail(f"nccl world ran on {out['nccl']['backend']}")
    summary = {
        "note": "2 ranks share one card's bandwidth; gloo stages every "
                "collective through the host: not a multi-GPU speed",
        "tp_ms_per_token": [r["tp_ms_per_token"] for r in ranks],
        "single_ms_per_token": [r["single_ms_per_token"] for r in ranks],
        "collective_ms": [r["collective_ms"] for r in ranks],
        "k1_ms_per_token": [r["k1_ms"]["per_token"] for r in ranks],
        "audit_bytes_by_axis": [r["audit"]["bytes_by_axis"] for r in ranks],
        "tp_held": [r["tp_logits"]["held"] for r in ranks],
        "tp_free_rel_l2": [r["tp_logits"]["free_rel_l2"] for r in ranks],
        "pipeline_rel_l2": [[r["pipeline"][p]["rel_l2"] for p in
                             ("prefill", "decode")] for r in ranks],
        "ring_rel_l2": [r["ring"]["last_logits"]["rel_l2"] for r in ranks],
        "engines_wall_s": [{k: r["engines"][k]["wall_s"]
                            for k in PAR_ENGINES} for r in ranks],
        "eager_under_mesh": [r["multi_step"]["eager_under_mesh"]
                             for r in ranks],
        "load_s": [r["load_s"] for r in ranks],
        "gloo_world_s": out["gloo_world_s"],
        "nccl_world_s": out["nccl_world_s"],
        "nccl_rel_l2": out["nccl"]["logits"]["rel_l2"],
    }
    out["summary"] = summary
    emit({"parallel_summary": summary})
    out["launches"] = parallel_launches(ranks)
    return out


def parallel_launches(ranks) -> dict:
    """The kernels' launches over the phase's counted runs, summed over
    the ranks: the engines, the pipeline and the ring (each zeroed just
    before and read just after its run), and one TP decode forward."""
    total = dict.fromkeys(("qmatmul", "dense_attention", "paged_attention"),
                          0)
    for r in ranks:
        for ls in ([r["engines"][k]["launches"] for k in PAR_ENGINES]
                   + [r["pipeline"]["launches"], r["ring"]["launches"],
                      r["decode_launches"]]):
            for k in total:
                total[k] += ls[k]
    return total


# the kernels at a model=2 rank's shapes of LLaMA-7B: K1 over each
# projection's shard at M=1 (decode) and 64 (an engine's prefill chunk), K2
# and K4 over 16 local heads
SHARD_SHAPES = [("qkv", E, 3 * E // 2), ("wo", E // 2, E),
                ("gate_up", E, FF), ("down", FF // 2, E),
                ("lm_head", E, V // 2)]
SHARD_DENSE_CASE = ("tp2_16h", "bf16", 512, (512,), H // 2, 1, False, True)
SHARD_PAGED_CASE = ("tp2_16h", "int8", SERVE_PAGE, 4, ("all", 300), H // 2,
                    1, False)


def shard_kernel_phase(dev, timer) -> dict:
    from llm_tpu_torch.ggml.types import GgmlType

    rng = np.random.default_rng(19)
    k1 = []
    for name, K, R in SHARD_SHAPES:
        w = random_weight(GgmlType.Q4_0, K, R, rng, dev)
        for M in (1, 64):
            k1.append(check_qmatmul(f"tp2_{name}", w, M, rng, dev, timer,
                                    timed=True))
        del w
    name, kv, W, n_past, hkv, rep, alibi, timed = SHARD_DENSE_CASE
    k2 = check_attention(name, kv, W, list(n_past), hkv, rep, alibi, rng,
                         dev, timer, timed)
    k4 = check_paged(SHARD_PAGED_CASE, rng, dev, timer)
    torch.cuda.empty_cache()
    bad = [r for r in k1 + [k2, k4] if not r["ok"]]
    if bad:
        fail(f"shard shapes: kernels out of tolerance: {bad[:2]}")
    per = {"qkv": N_LAYER, "wo": N_LAYER, "gate_up": N_LAYER,
           "down": N_LAYER, "lm_head": 1}

    def token(key, M):
        return sum(r[key] * per[r["case"][4:]] for r in k1 if r["M"] == M)

    out = {"qmatmul": k1, "dense_attention": k2, "paged_attention": k4,
           "per_token": {f"M{M}": {k: token(k, M) for k in (
               "ms", "plain_ms", "library_ms", "bound_ms")}
               for M in (1, 64)}}
    emit({"shard_kernels": {"k1_per_token": out["per_token"],
                            **{n: {k: out[n][k] for k in (
                                "ms", "bound_ms", "plain_ms", "library_ms",
                                "max_abs_err")}
                               for n in ("dense_attention",
                                         "paged_attention")}}})
    return out


# ---------------------------------------------------------------------------
# multihost: multi-controller serving (parallel/multihost.py) on the card

MH_WORLD = 2  # ranks, (data, model) = (2, 1): a host is one rank
MH_STREAMS = 2  # a row's slots (global 4)
MH_PROMPT, MH_NEW, MH_BLOCK = 64, 16, 16
MH_TIMED_STEPS = 8
MH_IDLE_GATHERS = 100
MH_TIMEOUT = 240  # s the world may run before it is killed
MH_CKPT_PAGES = 3  # the checkpointed engine's pool: trash + a page a row
MH_CLI_TIMEOUT = 120
# the kernels at a multi-host row's shapes: K1 over the 7B projections at
# M = 128 (the row's [2, 64] prefill chunk), K2 (bf16 cache) and K4 (int8
# pool) at the row's 2 streams
MH_DENSE_CASE = ("mh_b2", "bf16", 512, (MH_PROMPT + MH_NEW,) * 2, H, 1,
                 False, True)
MH_PAGED_CASE = ("mh_b2", "int8", SERVE_PAGE, MH_STREAMS,
                 ("all", MH_PROMPT + MH_NEW), H, 1, False)


def mh_kernel_phase(dev, timer) -> dict:
    from llm_tpu_torch.ggml.types import GgmlType

    rng = np.random.default_rng(23)
    M = MH_STREAMS * MH_PROMPT
    k1 = []
    for name, K, R in SHAPES_7B:
        w = random_weight(GgmlType.Q4_0, K, R, rng, dev)
        k1.append(check_qmatmul(name, w, M, rng, dev, timer, timed=True))
        del w
    name, kv, W, n_past, hkv, rep, alibi, timed = MH_DENSE_CASE
    k2 = check_attention(name, kv, W, list(n_past), hkv, rep, alibi, rng,
                         dev, timer, timed)
    k4 = check_paged(MH_PAGED_CASE, rng, dev, timer)
    torch.cuda.empty_cache()
    bad = [r for r in k1 + [k2, k4] if not r["ok"]]
    if bad:
        fail(f"multihost shapes: kernels out of tolerance: {bad[:2]}")
    per = {"qkv": N_LAYER, "wo": N_LAYER, "gate_up": N_LAYER,
           "down": N_LAYER, "lm_head": 1}
    out = {"qmatmul": k1, "dense_attention": k2, "paged_attention": k4,
           "per_chunk": {f"M{M}": {k: sum(r[k] * per[r["case"]] for r in k1)
                                   for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms")}}}
    emit({"multihost_kernels": {
        "k1_per_129_launches": out["per_chunk"],
        **{n: {k: out[n][k] for k in ("ms", "bound_ms", "plain_ms",
                                      "library_ms", "max_abs_err")}
           for n in ("dense_attention", "paged_attention")}}})
    return out


class ForcedSampler:
    """A host sampler that answers with given tokens and records the
    logits it was asked to sample from: an engine's own path,
    teacher-forced."""

    def __init__(self, tokens):
        self.tokens = [int(t) for t in tokens]
        self.rows = []

    def sample(self, logits, prev, rng) -> int:
        self.rows.append(np.array(logits, np.float32))
        return self.tokens[min(len(self.rows), len(self.tokens)) - 1]


class RecordingGreedy:
    """Greedy, recording the logits of each pick."""

    def __init__(self):
        self.rows = []

    def sample(self, logits, prev, rng) -> int:
        self.rows.append(np.array(logits, np.float32))
        return int(np.argmax(logits))


def mh_generated(engine, ids) -> list:
    return [list(engine.finished[r].tokens[-engine.finished[r].generated:])
            for r in ids]


def mh_counted(engine, module, fn, attention, reqs, name, spec) -> dict:
    """One engine run in the world, host-stepped, with the launch counters
    zeroed just before and read just after, held exactly to its
    forwards."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.monotonic()
    with counted_forwards(module, fn) as counts:
        ids = [engine.submit(r) for r in reqs]
        while engine.has_work_global():
            engine.step()
    torch.cuda.synchronize()
    launches = read_launches()
    check_engine_launches(name, launches, dict(counts), attention, spec)
    return {"ids": ids, "tokens": mh_generated(engine, ids),
            "texts": ["".join(engine.finished[r].text) for r in ids],
            "launches": launches, "forwards": dict(counts),
            "wall_s": time.monotonic() - t0}


def mh_step_ms(engine, reqs) -> dict:
    """Host ms of a decode step of the row's 2 streams, over
    MH_TIMED_STEPS steps in lockstep (after the step that prefills the
    prompts), with the control all-gathers' count and ms."""
    control = engine.control
    for r in reqs:
        engine.submit(r)
    engine.step()
    control.gathers, control.gather_s = 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MH_TIMED_STEPS):
        engine.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gathers, gather_s = control.gathers, control.gather_s
    while engine.has_work_global():
        engine.step()
    return {"ms_per_step": dt * 1e3 / MH_TIMED_STEPS,
            "control_gathers_per_step": gathers / MH_TIMED_STEPS,
            "control_gather_ms": gather_s * 1e3 / max(gathers, 1),
            "control_ms_per_step": gather_s * 1e3 / MH_TIMED_STEPS}


def mh_parted(name, got: list, want: list, rows: list) -> list:
    """Streams whose tokens part from `want`'s; a part is allowed only at
    a near-tie of the recorded logits `rows` of `want`'s run."""
    parted = []
    for s, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        parted.append((s, i))
        if rows is not None and i < len(rows[s]):
            row = torch.from_numpy(rows[s][i])
            top1_held(f"{name} stream {s} at token {i}",
                      row.new_zeros(row.shape).index_fill_(
                          0, torch.tensor([int(g[i])]), 1.0)[None],
                      row[None])
    return parted


def mh_forced(name, make_mh, make_single, prompts, want) -> dict:
    """Teacher forcing through the engines' own paths: both answer with
    `want`'s tokens; their logits rows are held within E2E_REL_L2 with
    top-1 equal (but at a near-tie)."""
    from llm_tpu_torch.serve import GenerationRequest

    runs = []
    for make, collective in ((make_mh, True), (make_single, False)):
        engine = make()
        forced = [ForcedSampler(w) for w in want]
        for p, f, w in zip(prompts, forced, want):
            engine.submit(GenerationRequest(prompt=p, max_tokens=len(w),
                                            sampler=f))
        while (engine.has_work_global() if collective
               else engine.has_work()):
            engine.step()
        runs.append([f.rows for f in forced])
        del engine
    n = [min(len(a), len(b)) for a, b in zip(*runs)]
    got, ref = (torch.from_numpy(np.stack(
        [rows[i] for rows, k in zip(run, n) for i in range(k)]))
        for run in runs)
    return {**compare_logits(f"{name} forced", got, ref),
            **top1_held(f"{name} forced", got, ref)}


def multihost_rank(rank, world, path, device, store) -> dict:
    """One rank of the gloo world of 2 on the one card, (data, model) =
    (2, 1): the dense and paged multi-host engines on this row's 2
    prompts (host-stepped, launches exact), the paged engine's blocks of
    16 (CUDA graphs), each held against a single-card engine on the same
    prompts in this rank; an LlmServer on this row; the coordinated
    per-rank checkpoint of a paged engine with a stream in flight."""
    import os

    import torch.distributed as dist

    from llm_tpu_torch import loader
    from llm_tpu_torch import paged as paged_mod
    from llm_tpu_torch import serve as serve_mod
    from llm_tpu_torch.engine_snapshot import read_engine, write_engine
    from llm_tpu_torch.models import forward as fwd
    from llm_tpu_torch.ops.sampling import DeviceSampler
    from llm_tpu_torch.parallel import multihost as mh
    from llm_tpu_torch.parallel import sharding as sh
    from llm_tpu_torch.server import LlmServer, rank_snapshot_path
    from llm_tpu_torch.session import SnapshotError

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mh.CONTROL_TIMEOUT_S = float(MH_TIMEOUT)
    t0 = time.monotonic()
    model = loader.load(path, "llama",
                        params=loader.ModelParameters(context_size=CTX),
                        device=dev)
    spec = model.spec
    out = {"rank": rank, "load_s": time.monotonic() - t0}
    mesh = sh.make_mesh(sh.MeshConfig(data=world, model=1), device=dev)
    host = mesh.coords["data"]
    prompts = [p[:MH_PROMPT] for p in serve_prompts(MH_STREAMS * world)][
        MH_STREAMS * host: MH_STREAMS * (host + 1)]
    G = MH_STREAMS * world
    eager0 = fwd.EAGER_UNDER_MESH

    from llm_tpu_torch.samplers import GreedySampler

    def reqs(n=MH_NEW, samplers=None):
        return [serve_mod.GenerationRequest(
            prompt=p, max_tokens=n,
            sampler=samplers[i] if samplers else GreedySampler())
            for i, p in enumerate(prompts)]

    def dense():
        return mh.MultiHostEngine(model, mesh, global_streams=G,
                                  kv_dtype=torch.bfloat16, n_batch=MH_PROMPT)

    def paged(n_pages=None):
        return mh.MultiHostPagedEngine(
            model, mesh, global_streams=G, kv_dtype="int8",
            n_batch=MH_PROMPT, page_size=SERVE_PAGE, n_pages=n_pages)

    # (a) the dense bf16 engine, host-stepped; then its steps timed
    rec = [RecordingGreedy() for _ in prompts]
    e = dense()
    out["dense"] = mh_counted(e, mh, "forward_batched", "dense_attention",
                              reqs(samplers=rec), "multihost dense", spec)
    dense_rows = [r.rows for r in rec]
    out["dense"]["cache_k"] = list(e.cache.k.shape)
    out["dense_step"] = mh_step_ms(e, reqs())
    del e
    # (b) the paged int8 engine, host-stepped; its steps timed
    rec = [RecordingGreedy() for _ in prompts]
    p = paged()
    out["paged"] = mh_counted(p, paged_mod, "paged_forward_batched",
                              "paged_attention", reqs(samplers=rec),
                              "multihost paged", spec)
    paged_rows = [r.rows for r in rec]
    out["paged_step"] = mh_step_ms(p, reqs())
    # (c) its blocks of 16 with a greedy device sampler: CUDA graphs
    dreqs = [serve_mod.GenerationRequest(
        prompt=q, max_tokens=MH_NEW, device_sampler=DeviceSampler.greedy())
        for q in prompts]
    ids = [p.submit(r) for r in dreqs]
    while p.has_work_global():
        p.step_multi(MH_BLOCK)
    block = mh_generated(p, ids)
    # timed: a second run over the captured graph, its second block
    ids = [p.submit(serve_mod.GenerationRequest(
        prompt=q, max_tokens=3 * MH_BLOCK,
        device_sampler=DeviceSampler.greedy())) for q in prompts]
    p.step_multi(MH_BLOCK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.step_multi(MH_BLOCK)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) * 1e3 / MH_BLOCK
    while p.has_work_global():
        p.step_multi(MH_BLOCK)
    graphs = [{"launches_per_replay": g.launches, "replays": g.replays,
               "capture_s": g.capture_s} for g in p.pool.graphs.values()]
    want = {"qmatmul": 4 * N_LAYER + 1, "dense_attention": 0,
            "paged_attention": N_LAYER}
    if not graphs or any(g["launches_per_replay"] != want for g in graphs):
        fail(f"rank {rank}: multihost block graphs {graphs}")
    out["block"] = {"tokens": block, "ms_per_step": block_ms,
                    "graphs": graphs, "blocks": p.multi_blocks,
                    "eager_under_mesh": fwd.EAGER_UNDER_MESH - eager0,
                    "fallbacks": p.multi_fallbacks}
    if out["block"]["eager_under_mesh"] or p.multi_blocks < 3:
        fail(f"rank {rank}: multihost blocks {out['block']}")
    out["block"]["parted"] = mh_parted(f"rank {rank} block", block,
                                       out["paged"]["tokens"], paged_rows)

    # (d) LlmServer on this row: 2 completions at temperature 0 (the
    # server's chain: top-k 1 with the default repetition penalty), equal
    # to the engine's host-stepped run of that chain; a live checkpoint
    # refused; the consensus stop
    from llm_tpu_torch.server import sampler_from_params

    ids = [p.submit(r) for r in reqs(samplers=[
        sampler_from_params({"temperature": 0}, n_vocab=spec.n_vocab)
        for _ in prompts])]
    while p.has_work_global():
        p.step()
    served = ["".join(p.finished[r].text) for r in ids]
    srv = LlmServer(model, p, host="127.0.0.1", port=0)
    srv.start()
    host_, port_ = srv.address
    base = f"http://{host_}:{port_}"
    http = []
    for q in prompts:
        status, body, sec = http_json(base + "/v1/completions", {
            "prompt": q, "max_tokens": MH_NEW, "temperature": 0})
        http.append(body["choices"][0]["text"] if status == 200 else None)
    status, body, _ = http_json(base + "/admin/checkpoint", {})
    out["server"] = {"loop": type(srv.loop).__name__,
                     "texts_equal": http == served,
                     "live_checkpoint": [status, body]}
    if not out["server"]["texts_equal"] or status != 409:
        fail(f"rank {rank}: multihost server {out['server']}: {http} "
             f"against {served}")
    dist.barrier()
    if rank == 0:
        srv.loop.shutdown()
        time.sleep(0.5)
        out["server"]["alive_after_own_stop"] = srv.loop.is_alive()
    else:
        time.sleep(1.0)
        srv.loop.shutdown()
    srv.loop.join(timeout=60)
    out["server"]["loop_alive"] = srv.loop.is_alive()
    srv.httpd.shutdown()
    srv.httpd.server_close()
    if out["server"]["loop_alive"] or not out["server"].get(
            "alive_after_own_stop", True):
        fail(f"rank {rank}: multihost consensus stop {out['server']}")
    del srv, p
    torch.cuda.empty_cache()

    # (e) the coordinated per-rank checkpoint: one stream a row in flight
    ck = paged(MH_CKPT_PAGES)
    rid = ck.submit(reqs()[0])
    for _ in range(4):  # the prompt's chunk, then decodes
        ck.step()
    snap = rank_snapshot_path(ck, store / "engine.snap")
    t0 = time.monotonic()
    write_engine(ck, snap)
    write_s = time.monotonic() - t0
    fresh = paged(MH_CKPT_PAGES)
    t0 = time.monotonic()
    read_engine(fresh, snap)
    read_s = time.monotonic() - t0
    in_flight = fresh.active
    while ck.has_work_global():
        ck.step()
    while fresh.has_work_global():
        fresh.step()
    dist.barrier()
    other = Path(f"{store / 'engine.snap'}.host{1 - rank}")
    refused = None
    try:
        read_engine(paged(MH_CKPT_PAGES), other)
    except SnapshotError as e:
        refused = str(e)
    out["checkpoint"] = {
        "file": Path(snap).name, "bytes": os.path.getsize(snap),
        "write_s": write_s, "read_s": read_s, "in_flight": in_flight,
        "steps": fresh._steps,
        "tokens_equal": rid in fresh.finished and
        fresh.finished[rid].tokens == ck.finished[rid].tokens,
        "swapped_refused": refused}
    if not (out["checkpoint"]["tokens_equal"] and in_flight == 1
            and refused and refused.startswith("process layout mismatch")):
        fail(f"rank {rank}: multihost checkpoint {out['checkpoint']}")
    del ck, fresh
    torch.cuda.empty_cache()

    # (f) the single-card engines on this row's prompts, in this rank
    single = {}
    for kind, make in (
            ("dense", lambda: serve_mod.Engine(
                model, max_streams=MH_STREAMS, kv_dtype=torch.bfloat16,
                n_batch=MH_PROMPT)),
            ("paged", lambda: paged_mod.PagedEngine(
                model, max_streams=MH_STREAMS, page_size=SERVE_PAGE,
                kv_dtype="int8", n_batch=MH_PROMPT))):
        e = make()
        single[kind] = mh_generated(e, list(e.generate_all(reqs())))
        del e
    parted = {kind: mh_parted(f"rank {rank} {kind}",
                              out[kind]["tokens"], single[kind], None)
              for kind in ("dense", "paged")}
    out["single_parted"] = parted
    # where a row parts from the single card, the whole world holds the
    # teacher-forced logits (a collective decision)
    agreed = mh.ControlGroups.for_mesh(mesh).allgather(
        [int(bool(parted["dense"])), int(bool(parted["paged"]))], "forced")
    forced = {}
    for j, (kind, make_mh, make_single) in enumerate((
            ("dense", dense, lambda: serve_mod.Engine(
                model, max_streams=MH_STREAMS, kv_dtype=torch.bfloat16,
                n_batch=MH_PROMPT)),
            ("paged", paged, lambda: paged_mod.PagedEngine(
                model, max_streams=MH_STREAMS, page_size=SERVE_PAGE,
                kv_dtype="int8", n_batch=MH_PROMPT)))):
        if agreed[:, j].any():
            forced[kind] = mh_forced(f"rank {rank} {kind}", make_mh,
                                     make_single, prompts, single[kind])
    out["forced"] = forced
    out["held"] = {k: ("forced" if k in forced else "tokens")
                   for k in ("dense", "paged")}
    # the control all-gather alone, the ranks in step: a step's gathers
    # above also wait out the skew between the ranks' forwards
    control = mh.ControlGroups.for_mesh(mesh)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MH_IDLE_GATHERS):
        control.allgather([0, 0], "idle")
    out["control_gather_idle_ms"] = ((time.perf_counter() - t0) * 1e3
                                     / MH_IDLE_GATHERS)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    for k in ("dense", "paged"):
        out[k].pop("ids")
    return out


def mh_cli_nccl(store) -> dict:
    """`serve --multihost` of a world of one on nccl through the cli, on
    the 2-layer full-width model: one completion, then SIGINT; the
    process must exit 0 within MH_CLI_TIMEOUT."""
    import queue
    import signal
    import socket
    import threading

    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.testing import make_bench_file

    small = store / "llama7b-2layer.bin"
    make_bench_file("llama", small, GgmlType.Q4_0, seed=0, n_ff=FF,
                    n_vocab=V, n_embd=E, n_head=H, n_layer=NCCL_LAYERS,
                    n_mult=256)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = s.getsockname()[1]
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_tpu_torch", "serve", "-m", str(small),
         "-a", "llama", "--num-ctx-tokens", str(CTX), "--multihost",
         "--coordinator", f"127.0.0.1:{coord}", "--num-processes", "1",
         "--process-id", "0", "--port", "0", "--max-streams", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    seen = []
    try:
        while not seen or "serving" not in seen[-1]:
            seen.append(lines.get(timeout=MH_CLI_TIMEOUT))
        line = seen[-1].strip()
        if "rank 0 of 1 on nccl" not in line:
            fail(f"multihost cli: {line}")
        url = line.split(" on ")[1].split()[0]
        ready_s = time.monotonic() - t0
        status, body, sec = http_json(url + "/v1/completions", {
            "prompt": e2e_prompts()[0], "max_tokens": 4,
            "temperature": 0})
        if status != 200 or not body["choices"][0]["text"]:
            fail(f"multihost cli completion: {status} {body}")
        proc.send_signal(signal.SIGINT)
        t1 = time.monotonic()
        rc = proc.wait(timeout=MH_CLI_TIMEOUT)
        exit_s = time.monotonic() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        small.unlink(missing_ok=True)
    while not lines.empty():
        seen.append(lines.get())
    if rc != 0:
        fail(f"multihost cli exited {rc}: {''.join(seen[-20:])}")
    return {"serving_line": line, "ready_s": ready_s, "completion_s": sec,
            "exit_s": exit_s, "rc": rc}


def multihost_phase(dev) -> dict:
    """A gloo world of 2 ranks on the one card (`multihost_rank`) over the
    e2e LLaMA-7B Q4_0 file at full width and depth, (data, model) =
    (2, 1), then a world of one on nccl through the cli (`mh_cli_nccl`).
    The two ranks share one card: its times are not a multi-card speed."""
    import shutil

    from llm_tpu_torch.parallel import launch

    store = ROOT / "build" / "smoke" / "multihost"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    out = {}
    try:
        t0 = time.monotonic()
        ranks = launch.spawn(multihost_rank, MH_WORLD, "gloo", store / "gloo",
                             timeout=MH_TIMEOUT,
                             args=(str(bench_path()), str(dev), store))
        out["gloo_world_s"] = time.monotonic() - t0
        out["ranks"] = ranks
        t0 = time.monotonic()
        out["nccl_cli"] = mh_cli_nccl(store)
        out["nccl_cli_s"] = time.monotonic() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    launches = dict.fromkeys(("qmatmul", "dense_attention",
                              "paged_attention"), 0)
    for r in ranks:
        for kind in ("dense", "paged"):
            for k in launches:
                launches[k] += r[kind]["launches"][k]
        for g in r["block"]["graphs"]:
            for k in launches:
                launches[k] += g["launches_per_replay"][k] * g["replays"]
    out["launches"] = launches
    summary = {
        "note": "2 ranks share one card; a host is one rank; not a "
                "multi-card speed",
        "dense_step_ms": [r["dense_step"]["ms_per_step"] for r in ranks],
        "paged_step_ms": [r["paged_step"]["ms_per_step"] for r in ranks],
        "block_step_ms": [r["block"]["ms_per_step"] for r in ranks],
        "control_gather_ms": [r["paged_step"]["control_gather_ms"]
                              for r in ranks],
        "control_ms_per_step": [r["paged_step"]["control_ms_per_step"]
                                for r in ranks],
        "control_gather_idle_ms": [r["control_gather_idle_ms"]
                                   for r in ranks],
        "held": [r["held"] for r in ranks],
        "block_parted": [r["block"]["parted"] for r in ranks],
        "checkpoint": [{k: r["checkpoint"][k] for k in (
            "file", "bytes", "write_s", "read_s")} for r in ranks],
        "load_s": [r["load_s"] for r in ranks],
        "gloo_world_s": out["gloo_world_s"],
        "nccl_cli": out["nccl_cli"],
        "launches": launches,
    }
    out["summary"] = summary
    emit({"multihost_summary": summary})
    return out


def kernel_entries(qrecs, arecs, precs, e2e, serve, k3recs, k3eq,
                   cinf, dsamp, multi, archs,
                   session_paths, spec, slice_paths, shard,
                   mhk) -> list[dict]:
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
    and the verify harness; and the speculative phase's runs
    (`speculative`: eager launches plus each graph's launches times its
    replays), with K1 at the phase's new shapes in `speculative_by_case`
    (the 7B target at M=4, the 160M draft at M=1 and 16: one forward's
    launches each); and the runs of `slice_paths`: the routes phase (the
    7B server's chat, embeddings and checkpoint traffic, and the dense
    engine's round trip) and the adapters phase (GPT-2 117M quantized,
    LoRA-patched and upcast: counted launches plus each graph's launches
    times its replays), and the parallel phase (`parallel`: both ranks'
    engines, pipeline, ring and one TP decode forward), with K1, K2 and K4
    at a model=2 rank's shapes in `shard_by_case`, and the multihost phase
    (`multihost`: both ranks' host-stepped engine runs plus each block
    graph's launches times its replays), with K1 at M=128 and K2 and K4 at
    a row's 2 streams in `multihost_by_case`."""
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
        "by_M": step_by_m(k3recs),
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
          "by_M": step_by_m(qrecs)}),
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
        e["launches_by_path"]["speculative"] = spec["launches"][e["name"]]
        for path, ls in slice_paths.items():
            e["launches_by_path"][path] = ls[e["name"]]
    entries[1]["speculative_by_case"] = {
        name: case["per_token"] for name, case in spec["k1_cases"].items()}
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
        errs = ([r["max_abs_err"] for m in [*archs["models"].values(),
                                             *({"qmatmul": c} for c in
                                               spec["k1_cases"].values())]
                 for r in m["qmatmul"]["cases"]] if e["name"] == "qmatmul"
                else [archs["kernel_cases"][e["name"]]["max_abs_err"]])
        e["max_abs_err"] = max([e["max_abs_err"], *errs])
    # the kernels at a model=2 rank's shapes (16 local heads; K1 a token's
    # launches over the shards at M=1 and 64)
    # and at a multi-host row's shapes (K1 a [2, 64] prefill chunk's 129
    # launches at M=128; K2 and K4 at the row's 2 streams)
    for key, rec in (("shard_by_case", shard), ("multihost_by_case", mhk)):
        entries[1][key] = rec["per_token" if rec is shard else "per_chunk"]
        for e in entries[2:4]:
            r = rec[e["name"]]
            e[key] = {r["case"]: {k: r[k] for k in (
                "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                "max_abs_err")}}
        for e in entries[1:4]:
            errs = ([r["max_abs_err"] for r in rec["qmatmul"]]
                    if e["name"] == "qmatmul"
                    else [rec[e["name"]]["max_abs_err"]])
            e["max_abs_err"] = max([e["max_abs_err"], *errs])
    # the attention kernel's launches through its tensor-core branch
    # (gqa_mma), read from LAUNCHES_GQA_MMA: in the six architectures'
    # `infer` runs (Falcon-7B's, over the dense cache), and around the one
    # checked call of each timed kernel case (its timed repeats uncounted)
    entries[2]["launches_gqa_mma"] = {
        "archs_infer": sum(m["infer"]["gqa_mma_launches"]
                           for m in archs["models"].values()),
        "checked_calls": sum(r.get("gqa_mma_launches", 0) for r in arecs)}
    entries[3]["launches_gqa_mma"] = {
        "checked_calls": sum(r["gqa_mma_launches"] for r in precs)}
    # qmatmul's launches by consumer path, in each path's own run
    entries[1]["launches_by_consumer_path"] = {
        name: {"swapped": ls["qmatmul_swapped"], "wide": ls["qmatmul_wide"]}
        for name, ls in (("infer", e2e["launches"]),
                         ("serve_paged", serve["paged_launches"]),
                         ("serve_dense", serve["dense_launches"]),
                         *session_paths.items())}
    return entries


def codec_entry(crecs) -> dict:
    """The codec kernel's entry: ms, bound and plain ms summed over one
    decode of each of the ten formats at K 4096 x R 11008; launches of the
    e2e load (the main path's), and of every load by path (`load_record`:
    e2e, the pack phase's warm loads, gguf, the speculative draft, the six
    architectures, the adapters' GPT-2 loads). The parallel and multihost
    ranks load in their own processes and are not counted here."""
    ffn = [r for r in crecs if r["case"].endswith("_7b_ffn")]
    by_path: dict = {}
    for rec in CODEC_LOADS:
        p = rec["path"]
        key = ("pack" if p.startswith("pack_") else "archs"
               if p.startswith("archs_") else p)
        by_path[key] = by_path.get(key, 0) + rec["codec_launches"]
    return {
        "name": "codecs", "route": "cuda",
        "source": "llm_tpu_torch/csrc/codecs.cu",
        "replaces": "llm_tpu/native/codecs.cpp:240",
        "replaces_note": "not a TPU kernel: the counterpart of "
                         "llm_tpu/native/codecs.cpp, the JAX package's host "
                         "C++ codec (llm_transcode :240, its block decoders "
                         ":62-183)",
        "launches": by_path["e2e"], "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in crecs),
        "ms": sum(r["ms"] for r in ffn),
        "plain_ms": sum(r["plain_ms"] for r in ffn),
        "bound_ms": sum(r["bound_ms"] for r in ffn), "bound_by": "bytes",
        "library_ms": None,
        "per": "one decode of each of the ten formats at K 4096 x R 11008, "
               "summed",
        "tolerance": "bit-equal to the plain version and to the host "
                     "decode_blocks (q; scale and bias as bits)",
        "by_case": {r["case"]: {k: r[k] for k in (
            "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "max_abs_err")} for r in crecs if "ms" in r},
    }


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
        built = _build.build(["qmatmul", "paged_attention", "qmatmul_probe",
                              "codecs"])
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
          for k in ("dequant_sass", "main_loop_sass", "tensor_core_sass")})
    # the wide path's kernels on wgmma (HGMMA, no HMMA), the attention's
    # GQA branch on mma.sync (HMMA) without spills
    for name, tc in results["kernel_report"]["tensor_core_sass"].items():
        if not tc["ok"] or (name == "gqa_mma" and tc["spills"]):
            fail(f"kernel_report: {name}: {tc}")
    # every counted loop, the probes' cuts and modes too, found once
    for name, loop in results["kernel_report"]["main_loop_sass"].items():
        if "error" in loop:
            fail(f"kernel_report: {name}: {loop['error']}")

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
    arecs = attention_phase(dev, timer)
    precs = paged_phase(dev, timer)
    mrecs = attention_matrix(dev) + [check_repeat(dev)]
    lap("attention")
    checks = probe_checks(dev) + probe_checks_7b(dev)
    lap("probe_checks")
    shard = shard_kernel_phase(dev, timer)
    results["shard_kernels"] = shard
    lap("shard_kernels")
    mhk = mh_kernel_phase(dev, timer)
    results["multihost_kernels"] = mhk
    lap("multihost_kernels")
    crecs = codec_checks(dev, timer)
    lap("codecs")
    cases = qrecs + k3eq + k3recs + arecs + precs + mrecs + checks + crecs
    results["kernel_cases"] = cases
    emit({"kernel_cases": cases})
    bad = [r for r in cases if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad[:3]}")

    e2e, model = e2e_phase(dev)
    results["e2e"] = e2e
    emit({"e2e": e2e})
    lap("e2e")

    pack_llama = pack_case("llama7b_q4_0", bench_path(), "llama", model,
                           e2e["load_s"], CTX, dev)
    emit({"pack_llama7b_q4_0": pack_llama})
    lap("pack")

    par = parallel_phase(dev)
    results["parallel"] = par
    lap("parallel")

    mhp = multihost_phase(dev)
    results["multihost"] = mhp
    lap("multihost")

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
    lap("snapshot")

    ver = verify_phase(dev, gguf_path)
    results["verify"] = ver
    emit({"verify": ver})
    gc.collect()
    torch.cuda.empty_cache()
    lap("verify")

    spec = speculative_phase(model, dev, e2e, timer)
    results["speculative"] = spec
    emit({"speculative": spec})
    gc.collect()
    torch.cuda.empty_cache()
    lap("speculative")

    routes = routes_phase(model, dev)
    results["routes"] = routes
    emit({"routes": routes})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("routes")
    session_paths = {"gguf_infer": gguf["launches"],
                     "perplexity": ppl["launches"],
                     "snapshot": snap["launches"],
                     "verify": ver["launches"]}

    archs = archs_phase(dev, timer)
    results["archs"] = archs
    emit({"archs": archs})
    lap("archs")
    results["pack"] = {"llama7b_q4_0": pack_llama,
                       "mpt7b_q4_k": archs["models"]["mpt7b_q4_k"]["pack"]}
    emit({"pack_summary": results["pack"]})

    adapters = adapters_phase(dev)
    results["adapters"] = adapters
    emit({"adapters": adapters})
    lap("adapters")

    probes = probe_phase(dev)
    results["probes"] = probes
    lap("probes")

    kernels = kernel_entries(qrecs, arecs, precs, e2e, serve, k3recs, k3eq,
                             cinf, dsamp, multi, archs, session_paths,
                             spec, {"routes": routes["launches"],
                                    "adapters": adapters["launches"],
                                    "parallel": par["launches"],
                                    "multihost": mhp["launches"]}, shard,
                             mhk)
    kernels += probe_entries(probes, checks, dev, timer)
    kernels.append(codec_entry(crecs))
    del timer
    lap("kernel_entries")
    emit({"phase_s": phase_s})
    results["codec_loads"] = CODEC_LOADS
    emit({"codec_loads": CODEC_LOADS})
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
