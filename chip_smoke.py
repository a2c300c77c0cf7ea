#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`llm_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build:   nvcc compiles csrc/qmatmul.cu and csrc/dense_attention.cu for
            sm_90a, both at once, into build/kernels/.
2. kernels: each kernel's wrapper runs on the card at the LLaMA-7B shapes
            of the main path and is held against its plain PyTorch
            version on the same inputs; times of kernel, plain version,
            one PyTorch library call, and the card's bound.
3. e2e:     a full-width random LLaMA-7B Q4_0 checkpoint (seed 0, ~3.9 GB,
            written under build/smoke/ and removed afterwards) is loaded
            on the card, and `InferenceSession.infer` answers three greedy
            prompts (16, 64 and 1100 tokens, 32 new tokens each) with the
            launch counters set to 0 just before and read just after. The
            first prefill and decode logits are then held against the
            port's plain path on the same card.

Output: one JSON line per phase, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}. `--json PATH` also writes the
full results to PATH. Without a CUDA device it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
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
# - dense_attention: f32 throughout on both sides, split into other blocks:
#   m, l and acc within 1e-5 relative (of max|acc| for acc).
QM_TOL_PLAIN = 2.0**-7
QM_TOL_BF16 = 1e-5
ATTN_TOL = 1e-5


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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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
        for M in (1, N_BATCH):
            recs.append(check_qmatmul(name, w, M, rng, dev, timer, True))
        del w
    return recs


def check_attention(name, kv, W, n_past, hkv, rep, alibi, rng, dev, timer,
                    timed) -> dict:
    from types import SimpleNamespace

    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops.layers import alibi_slopes

    L, B, S = 2, 1, CTX
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
    npast = torch.full((B,), n_past, dtype=torch.int32, device=dev)
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
    if n_past == 0:  # the constants the caller's merge relies on
        ok = ok and bool((got[0] == da.NEG_INF).all()) and bool(
            (got[1] == 0).all()) and bool((got[2] == 0).all())
    rec = {"case": name, "kv": kv, "W": W, "n_past": n_past, "Hkv": hkv,
           "rep": rep, "alibi": alibi, "ok": bool(ok),
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
            mask = (torch.arange(W, device=dev) < n_past)[None, None, None]
            rec["library_ms"] = timer.ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q_b, k_w, v_w, attn_mask=mask, scale=spec.kq_scale))
        item = ck.element_size()
        n_bytes = (2 * B * hkv * W * D * item
                   + (2 * B * hkv * W * 4 if kv == "int8" else 0)
                   + qf.numel() * 4 + B * hkv * rep * (D + 2) * 4)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n_bytes, 4.0 * B * hkv * rep * W * D)
    return rec


def attention_phase(dev, timer) -> list[dict]:
    rng = np.random.default_rng(2)
    recs = []
    for kv in ("bf16", "int8"):
        for W in (512, 2048):
            for n_past in (0, W // 2 + 3, W):
                recs.append(check_attention(
                    "7b", kv, W, n_past, H, 1, False, rng, dev, timer,
                    timed=n_past == W))
    recs.append(check_attention("gqa_alibi", "bf16", 1536, 1100, 8, 4, True,
                                rng, dev, timer, timed=True))
    return recs


# ---------------------------------------------------------------------------
# phase 3: the main path end to end


@contextlib.contextmanager
def plain_versions():
    """Route both wrappers' CUDA calls to their plain versions (the
    reference run of this script only; the port itself never does this)."""
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import qmatmul as qm

    saved = qm.qmatmul_cuda, da.dense_attention_cuda
    qm.qmatmul_cuda = qm.qmatmul_plain
    da.dense_attention_cuda = da.dense_attention_plain
    try:
        yield
    finally:
        qm.qmatmul_cuda, da.dense_attention_cuda = saved


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
    """Where one decode token's time goes: host wall time per token, and
    the device kernels torch.profiler sees (time, launches, busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        "window": window_bucket(state["n"], spec.n_ctx),
        "wall_ms_per_token": wall_ms,
        "traced_wall_ms_per_token": traced_ms,
        "device_ms_per_token": (sum(t for t, _ in by_name.values()) / 1e3
                                / steps) if kernels else None,
        # the card's busy time over the untraced step: the profiler slows
        # the host, not the kernels
        "device_busy_share": (busy_us / 1e3 / steps / wall_ms
                              if kernels else None),  # None: none traced
        "device_launches_per_token": len(kernels) / steps,
        "top_device": [{"kernel": k[:80], "ms_per_token": t / 1e3 / steps,
                        "launches_per_token": c / steps}
                       for k, (t, c) in top[:8]],
    }


def e2e_phase(dev) -> dict:
    from llm_tpu_torch import loader
    from llm_tpu_torch.ggml.types import GgmlType
    from llm_tpu_torch.ops import dense_attention as da
    from llm_tpu_torch.ops import qmatmul as qm
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
    qm.LAUNCHES = 0
    da.LAUNCHES = 0
    online[0] = 0
    runs = [greedy_prompt_run(model, p) for p in prompts]
    launches = {"qmatmul": qm.LAUNCHES, "dense_attention": da.LAUNCHES}
    out["online_prefill_passes"] = online[0]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["runs"] = runs
    out["launches"] = launches

    # a step is a prefill chunk or a decode token; a 1-token chunk is
    # decode-shaped and reads the cache through the attention kernel too
    steps = sum(math.ceil(n / N_BATCH) + N_PREDICT for n in PROMPT_LENS)
    decode_steps = sum(N_PREDICT + (n % N_BATCH == 1) for n in PROMPT_LENS)
    want = {"qmatmul": (4 * N_LAYER + 1) * steps,
            "dense_attention": N_LAYER * decode_steps}
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
    for name, got, ref in (("prefill", pre_k, pre_p),
                           ("decode", dec_k, dec_p)):
        if got.shape != ref.shape or got.shape[-1] != V or \
                not bool(torch.isfinite(got).all()):
            fail(f"{name} logits {tuple(got.shape)} or non-finite")
        err = float((got - ref).abs().max())
        rel_l2 = float((got - ref).norm() / ref.norm())
        top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        out[f"{name}_logits"] = {"max_abs_err": err, "rel_l2": rel_l2,
                                 "max_abs": float(ref.abs().max()),
                                 "top1_agree": top1}
        if rel_l2 > E2E_REL_L2:
            fail(f"{name} logits differ from the plain path: rel L2 "
                 f"{rel_l2:.3g} > {E2E_REL_L2}")
    return out


# Kernel path vs plain path, full model: each of the 129 matmuls of a step
# rounds x and W to bf16 (relative error ~2^-8 per product, random in
# sign), and the errors travel down the 32-layer residual stream. Held to
# a relative L2 error of the logits of 2^-8: the whole model may drift no
# further than one product's rounding.
E2E_REL_L2 = 2.0**-8


# ---------------------------------------------------------------------------


def kernel_entries(qrecs, arecs, launches) -> list[dict]:
    """One entry per kernel: times summed over one decode token's launches
    at 7B (qmatmul: the 4 projections x 32 layers + lm_head at M=1;
    dense_attention: 32 layers at W=512, bf16 cache, full window)."""
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

    attn = [r for r in arecs if r["case"] == "7b" and r["kv"] == "bf16"
            and r["W"] == 512 and "ms" in r]

    def aw(r):
        return N_LAYER

    entries = []
    for name, recs, w, src, rep, extra in (
        ("qmatmul", dec, qw, "llm_tpu_torch/csrc/qmatmul.cu",
         "llm_tpu/ops/qmatmul.py:560",
         {"replaces_also": ["llm_tpu/ops/qmatmul.py:651",
                            "llm_tpu/ops/qmatmul.py:436",
                            "llm_tpu/ops/qmatmul.py:475"],
          "per": "one 7B decode token: 129 launches at M=1",
          "tolerance": "|y - plain| <= 2^-7 (|x| @ |W|)"}),
        ("dense_attention", attn, aw, "llm_tpu_torch/csrc/dense_attention.cu",
         "llm_tpu/ops/dense_attention.py:195",
         {"per": "one 7B decode token: 32 launches, W=512, bf16 cache",
          "tolerance": "m, l, acc within 1e-5 relative"}),
    ):
        all_recs = qrecs if name == "qmatmul" else arecs
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
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

    built = _build.build(["qmatmul", "dense_attention"])
    emit({"build": {"nvcc_s": built}})
    results["build"] = built

    timer = Timer(dev)
    qrecs = qmatmul_phase(dev, timer)
    arecs = attention_phase(dev, timer)
    results["kernel_cases"] = qrecs + arecs
    emit({"kernel_cases": qrecs + arecs})
    bad = [r for r in qrecs + arecs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad[:3]}")
    del timer

    e2e = e2e_phase(dev)
    results["e2e"] = e2e
    emit({"e2e": e2e})

    kernels = kernel_entries(qrecs, arecs, e2e["launches"])
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
