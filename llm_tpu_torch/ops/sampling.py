"""On-device token sampling for the decode loops.

The counterpart of `llm_tpu/ops/sampling.py`. `forward.decode_loop`
(one stream), `forward.decode_loop_batched` and `paged.paged_decode_loop`
(a batch of streams) sample each token on the model's device from the
current logits, so the host reads the tokens once per block of `n_steps`
(on the card: one CUDA graph replay a token, no host round trip).

Plain torch; the reference has no kernel here either. What the port keeps:

- The chain in the reference's order: flat bias -> windowed penalties ->
  top-k -> tail-free -> locally-typical -> top-p -> top-a -> min-p ->
  temperature -> terminal (Gumbel argmax, or mirostat 1/2).
- No branch on a tensor's value and no host sync: every truncation is a
  `torch.where` mask, so the step can be captured in a CUDA graph.
- The noise is an argument: `u` holds the uniforms in [1e-20, 1) of one
  token ([V]); `decode_loop` draws them from a `torch.Generator` a block at
  a time. Given the reference's uniforms, the picks are the reference's.
- Division by a config constant is a multiplication by its f32 reciprocal,
  as XLA computes it in the reference's jitted loop.
- A batch of streams with different samplers shares one static structure,
  `BatchedDeviceSampler`, whose per-stream values are tensors [B]
  (`batched_sampler`): the step divides by them, as the reference divides
  by its traced values, so they never become constants of a captured step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class DeviceSampler:
    """Static sampler config (hashable: one decode graph per config)."""

    kind: str = "greedy"  # "greedy" | "sample"
    temperature: float = 0.8
    top_k: int = 0  # 0 = no top-k truncation
    top_p: float = 1.0  # 1.0 = no nucleus truncation
    min_p: float = 0.0  # 0.0 = off; keep probs >= min_p * max prob
    bias: Tuple[Tuple[int, float], ...] = ()  # (token_id, additive bias)
    # windowed penalties over the last `penalty_last_n` tokens (the host
    # chain's Repetition and FreqPresence); they need a penalty_state
    # threaded through the decode loop
    repeat_penalty: float = 1.0  # 1.0 = off
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    penalty_last_n: int = 64
    # tail-free / locally-typical truncations; 1.0 = off. Every token tied
    # with the boundary value is kept.
    tail_free_z: float = 1.0
    typical_p: float = 1.0
    top_a: Tuple[float, float] = (0.0, 0.0)  # (a1, a2); (0, 0) = off
    # mirostat terminal: 0 = off, 1 | 2 the variant; the decode loop carries
    # mu in the sampler state (init 2 * tau, `mirostat_mu_init`)
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    mirostat_m: int = 100  # mirostat 1's Zipf-estimate depth

    @property
    def has_penalties(self) -> bool:
        return (
            self.repeat_penalty != 1.0
            or self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
        )

    @property
    def has_mu(self) -> bool:
        return self.mirostat != 0

    def __post_init__(self):
        if self.mirostat and (
            self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0
            or self.tail_free_z < 1.0 or self.typical_p < 1.0
            or self.top_a != (0.0, 0.0)
        ):
            raise ValueError(
                "mirostat cannot combine with top-k/top-p/top-a/min-p/"
                "tail-free/locally-typical (same rule as the host DSL)"
            )

    @classmethod
    def greedy(cls) -> "DeviceSampler":
        return cls(kind="greedy")

    @classmethod
    def top_k_temperature(cls, k: int = 40, temperature: float = 0.8):
        return cls(kind="sample", temperature=temperature, top_k=k)


@dataclass(frozen=True)
class BatchedDeviceSampler:
    """Static structure of a batch's per-stream sampling (hashable: one
    decode graph per structure). The per-stream values are tensors
    (`batched_sampler`), so streams with different temperatures, top-k,
    penalties or biases share one captured step."""

    sample: bool  # any stream non-greedy
    top_k_max: int  # the static k of the top-k pass; per-stream k <= it
    bias_tokens: Tuple[int, ...] = ()  # union of the biased token ids
    any_top_p: bool = False
    any_min_p: bool = False
    any_penalty: bool = False
    any_tail_free: bool = False
    any_typical: bool = False
    any_top_a: bool = False
    # 0: no mirostat stream; 1 | 2: every mirostat stream's variant (a
    # batch mixing them is rejected by batched_sampler)
    mirostat_kind: int = 0
    mirostat_m: int = 100
    # the static ring width: the largest window of the penalized streams
    # (the penalty values stay per stream)
    penalty_last_n: int = 64


def batched_sampler(samplers, n_slots: int, device=None):
    """(static BatchedDeviceSampler, per-stream value tensors on `device`)
    from per-slot DeviceSamplers; None entries sample greedily (their slots
    are dummies). Raises ValueError for a batch mixing mirostat 1 and 2."""
    live = [s for s in samplers if s is not None]
    sampled = [s for s in live if s.kind == "sample"]
    bias_tokens = tuple(sorted({t for s in live for t, _ in s.bias}))
    miro_kinds = {s.mirostat for s in live if s.mirostat}
    if len(miro_kinds) > 1:
        raise ValueError(
            "streams mixing mirostat 1 and mirostat 2 cannot share one "
            "batched decode block"
        )
    cfg = BatchedDeviceSampler(
        sample=bool(sampled),
        top_k_max=max((s.top_k for s in sampled), default=0),
        bias_tokens=bias_tokens,
        any_top_p=any(s.top_p < 1.0 for s in sampled),
        any_min_p=any(s.min_p > 0.0 for s in sampled),
        any_penalty=any(s.has_penalties for s in live),
        any_tail_free=any(s.tail_free_z < 1.0 for s in sampled),
        any_typical=any(s.typical_p < 1.0 for s in sampled),
        any_top_a=any(s.top_a != (0.0, 0.0) for s in sampled),
        mirostat_kind=miro_kinds.pop() if miro_kinds else 0,
        mirostat_m=max((s.mirostat_m for s in live if s.mirostat == 1),
                       default=100),
        penalty_last_n=max((s.penalty_last_n for s in live
                            if s.has_penalties), default=64),
    )
    f32 = np.float32
    v = {  # the neutral value of each feature
        "temperature": np.zeros(n_slots, f32),  # 0 = greedy
        "top_k": np.zeros(n_slots, np.int32),  # 0 = off
        "top_p": np.ones(n_slots, f32),
        "min_p": np.zeros(n_slots, f32),
        "repeat_penalty": np.ones(n_slots, f32),
        "frequency_penalty": np.zeros(n_slots, f32),
        "presence_penalty": np.zeros(n_slots, f32),
        "bias": np.zeros((n_slots, len(bias_tokens)), f32),
        "tail_free_z": np.ones(n_slots, f32),
        "typical_p": np.ones(n_slots, f32),
        "top_a1": np.zeros(n_slots, f32),
        "top_a2": np.zeros(n_slots, f32),
        "mirostat_on": np.zeros(n_slots, bool),
        "mirostat_tau": np.full(n_slots, 5.0, f32),
        "mirostat_eta": np.full(n_slots, 0.1, f32),
        "mirostat_m": np.full(n_slots, cfg.mirostat_m, np.int32),
    }
    col = {t: i for i, t in enumerate(bias_tokens)}
    for i, s in enumerate(samplers):
        if s is None:
            continue
        if s.kind == "sample":
            v["temperature"][i] = s.temperature
            v["top_k"][i] = s.top_k
            v["top_p"][i] = s.top_p
            v["min_p"][i] = s.min_p
            v["tail_free_z"][i] = s.tail_free_z
            v["typical_p"][i] = s.typical_p
            v["top_a1"][i], v["top_a2"][i] = s.top_a
            v["mirostat_on"][i] = s.mirostat != 0
            v["mirostat_tau"][i] = s.mirostat_tau
            v["mirostat_eta"][i] = s.mirostat_eta
        if s.mirostat == 1:
            v["mirostat_m"][i] = s.mirostat_m
        v["repeat_penalty"][i] = s.repeat_penalty
        v["frequency_penalty"][i] = s.frequency_penalty
        v["presence_penalty"][i] = s.presence_penalty
        for t, b in s.bias:
            v["bias"][i, col[t]] = b
    keys = _value_keys(cfg)
    return cfg, {k: torch.from_numpy(v[k]).to(device) for k in keys}


_BASE_KEYS = ("temperature", "top_k", "top_p", "min_p", "repeat_penalty",
              "frequency_penalty", "presence_penalty", "bias")


def _value_keys(cfg: BatchedDeviceSampler) -> tuple:
    """The value tensors the structure reads, in the reference's order."""
    keys = list(_BASE_KEYS)
    if cfg.any_tail_free:
        keys.append("tail_free_z")
    if cfg.any_typical:
        keys.append("typical_p")
    if cfg.any_top_a:
        keys += ["top_a1", "top_a2"]
    if cfg.mirostat_kind:
        keys += ["mirostat_on", "mirostat_tau", "mirostat_eta"]
    if cfg.mirostat_kind == 1:
        keys.append("mirostat_m")
    return tuple(keys)


def ensure_value_keys(values: dict, cfg: BatchedDeviceSampler,
                      n_slots: int) -> dict:
    """Fill neutral value tensors [n_slots] for features the structure
    enables but `values` lacks (a structure agreed across several
    value sets: each must hand the step the same keys)."""
    dev = next(iter(values.values())).device if values else None
    neutral = {
        "tail_free_z": (1.0, torch.float32), "typical_p": (1.0, torch.float32),
        "top_a1": (0.0, torch.float32), "top_a2": (0.0, torch.float32),
        "mirostat_on": (False, torch.bool),
        "mirostat_tau": (5.0, torch.float32),
        "mirostat_eta": (0.1, torch.float32),
        "mirostat_m": (cfg.mirostat_m, torch.int32),
    }
    v = dict(values)
    for k in _value_keys(cfg):
        if k not in v and k in neutral:
            fill, dt = neutral[k]
            v[k] = torch.full((n_slots,), fill, dtype=dt, device=dev)
    return v


def _recip(c: float) -> float:
    """The f32 reciprocal of a config constant (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(c))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's formula over the last axis; -inf lanes give 0."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("-inf"), dtype=x.dtype, device=x.device)


def _top_p_truncate(x: torch.Tensor, p, iters: int = 24):
    """Nucleus truncation without a vocab sort: bisect the probability
    cutoff c (mass(c), the sum of probs >= c, falls as c rises) to the
    largest c with mass(c) >= p, in `iters` masked sums. Keeps the
    smallest top-probability set with mass >= p, ties included. `p` is a
    float or a tensor of one value a row; a row at p >= 1 keeps all."""
    probs = _softmax(x)
    lo = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    hi = torch.amax(probs, dim=-1)
    zero = torch.zeros((), dtype=probs.dtype, device=x.device)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.sum(torch.where(probs >= mid[..., None], probs, zero),
                         dim=-1)
        ok = mass >= p  # mid keeps enough mass: the cutoff can rise
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(probs >= lo[..., None], x, _neg_inf(x))


def penalty_state(histories, last_n: int, n_vocab: int,
                  unbounded_floor: int = 0, device=None) -> dict:
    """Sampler state for windowed penalties: per-stream token counts over
    the last `last_n` tokens [B, V] f32, the window as a ring [B, last_n]
    int32 (-1 while filling) and the next write position [B] int32.

    `last_n` <= 0 (or >= 2**30) penalizes the whole history: the ring
    sizes to the longest history plus 256 tokens of headroom, rounded up
    to 64 (at least 64)."""
    B = len(histories)
    if last_n <= 0 or last_n >= 1 << 30:
        longest = max(max((len(h) for h in histories), default=0),
                      unbounded_floor)
        last_n = max(64, -(-(longest + 256) // 64) * 64)
    counts = np.zeros((B, n_vocab), np.float32)
    ring = np.full((B, last_n), -1, np.int32)
    pos = np.zeros(B, np.int32)
    for b, hist in enumerate(histories):
        w = list(hist)[-last_n:]
        for t in w:
            counts[b, t] += 1.0
        ring[b, : len(w)] = w
        pos[b] = len(w) % last_n  # full window: next write = oldest (idx 0)
    return {
        "counts": torch.from_numpy(counts).to(device),
        "ring": torch.from_numpy(ring).to(device),
        "pos": torch.from_numpy(pos).to(device),
    }


def update_penalty_state(state: Optional[dict], toks: torch.Tensor):
    """Fold freshly sampled tokens into the window: expire the slot being
    overwritten, count the new token. Leading batch dims are free ([] for
    the single-stream loop, [B] batched). Returns a new state."""
    if state is None or "counts" not in state:
        return state  # mirostat-only state has no penalty window
    counts, ring, pos = state["counts"], state["ring"], state["pos"]
    c2 = counts.reshape(-1, counts.shape[-1])
    r2 = ring.reshape(-1, ring.shape[-1])
    p2 = pos.reshape(-1, 1).long()
    t2 = toks.reshape(-1, 1).long()
    expired = r2.gather(1, p2)  # -1 while the window is still filling
    c2 = c2.scatter_add(1, expired.clamp(min=0),
                        torch.where(expired >= 0, -1.0, 0.0).to(c2.dtype))
    c2 = c2.scatter_add(1, t2, torch.ones_like(t2, dtype=c2.dtype))
    r2 = r2.scatter(1, p2, t2.to(r2.dtype))
    p2 = (p2 + 1) % ring.shape[-1]
    return {
        **state,  # keeps the mirostat "mu"
        "counts": c2.reshape(counts.shape),
        "ring": r2.reshape(ring.shape),
        "pos": p2.to(pos.dtype).reshape(pos.shape),
    }


def _apply_penalties(x: torch.Tensor, state: dict, cfg, values=None):
    """The host chain's Repetition (presence-gated l/p | l*p) and
    FreqPresence (-count*freq - presence) over the windowed counts. A
    BatchedDeviceSampler takes each stream's values [B] from `values` and
    divides by its penalty, as the reference divides by a traced value."""
    counts = state["counts"]
    seen = counts > 0
    if isinstance(cfg, BatchedDeviceSampler):
        rp = values["repeat_penalty"][:, None]
        x = torch.where(seen, torch.where(x < 0, x * rp, x / rp), x)
        return x - counts * values["frequency_penalty"][:, None] \
            - seen.to(x.dtype) * values["presence_penalty"][:, None]
    rp = cfg.repeat_penalty
    x = torch.where(seen, torch.where(x < 0, x * rp, x * _recip(rp)), x)
    return x - counts * cfg.frequency_penalty \
        - seen.to(x.dtype) * cfg.presence_penalty


def _min_p_truncate(x: torch.Tensor, min_p):
    """Keep tokens whose probability is at least min_p times the top one;
    `min_p` a float or one value a row (0 keeps everything)."""
    probs = _softmax(x)
    cutoff = min_p * torch.amax(probs, dim=-1)
    return torch.where(probs >= cutoff[..., None], x, _neg_inf(x))


def _sort_desc(x: torch.Tensor) -> torch.Tensor:
    """Values of the last axis in descending order (the reference's
    flip of an ascending sort)."""
    return torch.flip(torch.sort(x, dim=-1, stable=True).values, dims=(-1,))


def _tail_free_truncate(x: torch.Tensor, z):
    """Tail-free truncation: sort probs descending, normalize the |second
    difference|, keep tokens up to the cumulative-z point. `z` a float or
    one value a row; a row at z >= 1 keeps everything."""
    rows = isinstance(z, torch.Tensor)
    if not rows and z >= 1.0:
        return x
    V = x.shape[-1]
    svals = _sort_desc(x)
    p = _softmax(svals)
    d2 = torch.abs(torch.diff(p, n=2, dim=-1))  # [.., V-2]
    s = torch.sum(d2, dim=-1, keepdim=True)
    d2 = torch.where(s > 0, d2 / torch.where(s > 0, s, torch.ones_like(s)),
                     d2)
    cum = torch.cumsum(d2, dim=-1)
    # np.searchsorted(cum, z) == count of cum entries < z; keep = idx + 1
    zc = z[..., None] if rows else z
    keep = torch.sum((cum < zc).to(torch.int64), dim=-1) + 1
    cutoff = torch.gather(svals, -1, torch.clamp(keep - 1, 0, V - 1)[..., None])
    out = torch.where(x >= cutoff, x, _neg_inf(x))
    return torch.where(zc >= 1.0, x, out) if rows else out


def _typical_truncate(x: torch.Tensor, p):
    """Locally-typical truncation: rank tokens by |surprise - entropy|
    ascending, keep the smallest prefix reaching cumulative probability p.
    `p` a float or one value a row; a row at p >= 1 keeps everything."""
    rows = isinstance(p, torch.Tensor)
    if not rows and p >= 1.0:
        return x
    V = x.shape[-1]
    probs = _softmax(x)
    pos = probs > 0
    nlp = torch.where(pos, -torch.log(torch.where(pos, probs,
                                                  torch.ones_like(probs))),
                      torch.full_like(probs, float("inf")))
    ent = torch.sum(torch.where(pos, probs * nlp, torch.zeros_like(probs)),
                    dim=-1, keepdim=True)
    shifted = torch.abs(nlp - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)  # ascending
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    pc = p[..., None] if rows else p
    keep = torch.sum((cum < pc).to(torch.int64), dim=-1) + 1
    ss = torch.gather(shifted, -1, order)
    cutoff = torch.gather(ss, -1, torch.clamp(keep - 1, 0, V - 1)[..., None])
    out = torch.where(shifted <= cutoff, x, _neg_inf(x))
    return torch.where(pc >= 1.0, x, out) if rows else out


def _top_a_truncate(x: torch.Tensor, a1, a2):
    """Top-A truncation: keep tokens with probability >= a1 * pmax**a2;
    rows where that would keep nothing (or a1 == a2 == 0) pass through.
    `a1`, `a2` floats or one value a row each."""
    probs = _softmax(x)
    pmax = torch.amax(probs, dim=-1)
    limit = a1 * torch.pow(pmax, a2)
    keep = probs >= limit[..., None]
    on = ((a1 != 0.0) | (a2 != 0.0)) if isinstance(a1, torch.Tensor) \
        else ((a1 != 0.0) or (a2 != 0.0))
    active = on & (torch.sum(keep, dim=-1) >= 1)
    return torch.where(active[..., None] & ~keep, _neg_inf(x), x)


def mirostat_mu_init(cfg) -> float:
    """Initial mu of a mirostat sampler (host: mu = 2 * tau)."""
    return 2.0 * cfg.mirostat_tau


def _gumbel_pick(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """argmax(x + Gumbel noise) over the last axis, the noise from the
    uniforms `u` (x's shape, in [1e-20, 1)): a sample of softmax(x)."""
    g = -torch.log(-torch.log(u))
    return torch.argmax(x + g, dim=-1).to(torch.int32)


_LOG2E = 1.4426950408889634


def _mirostat_sample(x, u, mu, tau, eta, kind: int, m: int, m_vals=None):
    """Mirostat 1/2 terminal over (temperature-scaled) logits x [.., V]
    with mu [..]; returns (tok [..], new mu [..]). `tau` and `eta` are
    floats or one value a row; `m_vals` [..] gives each row its own Zipf
    depth below the static bound `m`.

    - kind 2: keep tokens whose surprise -log2(p) <= mu (the top token
      when none qualifies), sample from the kept set, update
      mu -= eta * (surprise(tok) - tau) with the full-vocab surprise.
    - kind 1: estimate the Zipf exponent s_hat from the top-m sorted
      probabilities, derive k from mu, truncate to the top k, sample, the
      same mu update."""
    V = x.shape[-1]
    probs = _softmax(x)
    pos = probs > 0
    # p = 0: infinite surprise, never kept (its masked logit is -inf)
    surprises = torch.where(
        pos, -torch.log(torch.where(pos, probs, torch.ones_like(probs)))
        * _LOG2E, torch.full_like(probs, float("inf")))
    if kind == 2:
        keepm = surprises <= mu[..., None]
        any_keep = torch.any(keepm, dim=-1, keepdim=True)
        top = probs >= torch.amax(probs, dim=-1, keepdim=True)
        keepm = torch.where(any_keep, keepm, top)
        xm = torch.where(keepm, x, _neg_inf(x))
    else:
        svals = _sort_desc(x)
        sp = _softmax(svals)
        mm = min(m, V - 1)
        i = torch.arange(max(mm - 1, 0), dtype=torch.float32, device=x.device)
        t_i = torch.log((i + 2.0) / (i + 1.0))
        pi = sp[..., : max(mm - 1, 0)]
        pj = sp[..., 1:max(mm, 1)]
        b_i = torch.where(pj > 0, torch.log(
            pi / torch.where(pj > 0, pj, torch.ones_like(pj))),
            torch.zeros_like(pj))
        if m_vals is None:
            den = torch.sum(t_i * t_i)
            num = torch.sum(t_i * b_i, dim=-1)
        else:  # per-row m: the estimate terms past a row's m are masked
            mv = torch.clamp(m_vals.to(torch.float32), max=float(V - 1))
            wm = (i < mv[..., None] - 1.0).to(torch.float32)
            den = torch.sum(t_i * t_i * wm, dim=-1)
            num = torch.sum(t_i * b_i * wm, dim=-1)
        # den == 0 (m <= 1 or V == 2): no estimate terms; the host keeps
        # the full vocab (s_hat = 1)
        s_hat = torch.where(den > 0, num / torch.where(den > 0, den,
                                                       torch.ones_like(den)),
                            torch.ones_like(num))
        eps = s_hat - 1.0
        k_f = ((eps * torch.exp2(mu)) / (1.0 - torch.pow(float(V), -eps))) \
            ** (1.0 / s_hat)
        # f32 -> int as XLA converts: saturating, NaN -> 0; then clipped
        k_r = torch.nan_to_num(torch.round(k_f), nan=0.0, posinf=float(V),
                               neginf=1.0)
        k = torch.where(eps == 0.0, torch.full_like(k_r, float(V)),
                        torch.clamp(k_r, 1.0, float(V))).to(torch.int64)
        cutoff = torch.gather(svals, -1, torch.clamp(k - 1, 0, V - 1)[..., None])
        xm = torch.where(x >= cutoff, x, _neg_inf(x))
    tok = _gumbel_pick(xm, u)
    surprise = torch.gather(surprises, -1, tok[..., None].long())[..., 0]
    return tok, mu - eta * (surprise - tau)


def bias_vector(cfg: DeviceSampler, n_vocab: int,
                device=None) -> Optional[torch.Tensor]:
    """The flat bias as a [V] f32 vector (None without one). A token named
    twice gets the sum of its biases (the CLI's TokenBias names each once)."""
    if not cfg.bias:
        return None
    vec = np.zeros(n_vocab, np.float32)
    for tid, b in cfg.bias:
        vec[tid] += np.float32(b)
    return torch.from_numpy(vec).to(device)


def device_sample(logits: torch.Tensor, u: Optional[torch.Tensor],
                  cfg, penalty_state: Optional[dict] = None,
                  bias: Optional[torch.Tensor] = None,
                  values: Optional[dict] = None) -> torch.Tensor:
    """Sample token ids [...] from logits [..., V] f32 under `cfg`, a
    DeviceSampler or (logits [B, V]) a BatchedDeviceSampler with its
    per-stream `values`.

    Stateless view: the mirostat mu update is discarded; decode loops use
    `device_sample_step`. `u`: the uniforms (logits' shape; unused when
    greedy). `bias`: `bias_vector(cfg, ...)`, built here when None."""
    tok, _ = _sample_core(logits, u, cfg, penalty_state, bias, values)
    return tok


def device_sample_step(logits: torch.Tensor, u: Optional[torch.Tensor],
                       cfg, state: Optional[dict] = None,
                       bias: Optional[torch.Tensor] = None,
                       values: Optional[dict] = None):
    """Sample and advance the sampler state: the penalty window takes the
    token, the mirostat mu its update. Returns (tokens, new state); a None
    state passes through."""
    tok, mu = _sample_core(logits, u, cfg, state, bias, values)
    state = update_penalty_state(state, tok)
    if mu is not None:
        state = {**(state or {}), "mu": mu}
    return tok, state


def _sample_core(logits, u, cfg, state, bias, values=None):
    """-> (tokens int32, new mu | None)."""
    if isinstance(cfg, BatchedDeviceSampler):
        return _device_sample_batched(logits, u, cfg, values, state)
    if cfg.bias:
        if bias is None:
            bias = bias_vector(cfg, logits.shape[-1], logits.device)
        logits = logits + bias
    if state is not None and cfg.has_penalties:
        logits = _apply_penalties(logits, state, cfg)

    if cfg.kind == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32), None

    # truncations on the raw (biased) logits, then temperature: the host
    # chain's order
    x = logits
    V = logits.shape[-1]
    if 0 < cfg.top_k < V:
        kth = torch.topk(x, cfg.top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, _neg_inf(x), x)
    x = _tail_free_truncate(x, cfg.tail_free_z)
    x = _typical_truncate(x, cfg.typical_p)
    if cfg.top_p < 1.0:
        x = _top_p_truncate(x, cfg.top_p)
    if cfg.top_a != (0.0, 0.0):
        x = _top_a_truncate(x, cfg.top_a[0], cfg.top_a[1])
    if cfg.min_p > 0.0:
        x = _min_p_truncate(x, cfg.min_p)
    x = x * _recip(max(cfg.temperature, 1e-6))
    if cfg.mirostat:
        if state is None or "mu" not in state:
            raise ValueError("mirostat needs the mu carry in the sampler "
                             "state (mirostat_mu_init)")
        return _mirostat_sample(x, u, state["mu"], cfg.mirostat_tau,
                                cfg.mirostat_eta, cfg.mirostat,
                                cfg.mirostat_m)
    return _gumbel_pick(x, u), None


@functools.lru_cache(maxsize=64)
def _bias_cols(tokens: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The biased token ids of a structure on `device`, built once, so a
    captured step copies nothing from the host. Callers must not write to
    the result."""
    return torch.tensor(tokens, dtype=torch.int64, device=device)


def _device_sample_batched(logits: torch.Tensor, u: Optional[torch.Tensor],
                           cfg: BatchedDeviceSampler, values: dict,
                           state: Optional[dict] = None):
    """Logits [B, V] with each stream's own temperature (0 = greedy),
    top-k (0 = off), top-p, min-p, tail-free, typical, top-a, windowed
    penalties, mirostat and flat bias, in one pass over the batch. `u`
    [B, V]: the step's uniforms, the same draw for the Gumbel pick and
    the mirostat pick (as the reference uses one key for both). Returns
    (tokens [B], new mu [B] | None)."""
    B, V = logits.shape
    if cfg.bias_tokens:
        logits = logits.index_add(
            1, _bias_cols(cfg.bias_tokens, logits.device), values["bias"])
    if state is not None and cfg.any_penalty:
        logits = _apply_penalties(logits, state, cfg, values)
    if not cfg.sample:
        return torch.argmax(logits, dim=-1).to(torch.int32), None

    t = values["temperature"][:, None]  # [B, 1]
    x = logits
    if 0 < cfg.top_k_max < V:
        k = values["top_k"].to(torch.int64)  # [B]
        vals = torch.topk(x, cfg.top_k_max, dim=-1).values  # descending
        idx = torch.clamp(k - 1, 0, cfg.top_k_max - 1)
        kth = torch.gather(vals, 1, idx[:, None])  # [B, 1]
        kth = torch.where(k[:, None] > 0, kth, _neg_inf(x))
        x = torch.where(x < kth, _neg_inf(x), x)
    if cfg.any_tail_free:
        x = _tail_free_truncate(x, values["tail_free_z"])
    if cfg.any_typical:
        x = _typical_truncate(x, values["typical_p"])
    if cfg.any_top_p:
        x = _top_p_truncate(x, values["top_p"])
    if cfg.any_top_a:
        x = _top_a_truncate(x, values["top_a1"], values["top_a2"])
    if cfg.any_min_p:
        x = _min_p_truncate(x, values["min_p"])
    x = x / torch.clamp(t, min=1e-6)
    g = -torch.log(-torch.log(u))
    # temperature 0: greedy for that stream, no noise
    std_tok = torch.argmax(x + torch.where(t > 0, g, 0.0),
                           dim=-1).to(torch.int32)
    if not cfg.mirostat_kind:
        return std_tok, None
    if state is None or "mu" not in state:
        raise ValueError("mirostat streams need the mu carry in the "
                         "sampler state")
    on = values["mirostat_on"]
    m_tok, m_mu = _mirostat_sample(
        x, u, state["mu"], values["mirostat_tau"], values["mirostat_eta"],
        cfg.mirostat_kind, cfg.mirostat_m, m_vals=values.get("mirostat_m"))
    return torch.where(on, m_tok, std_tok), torch.where(on, m_mu, state["mu"])


def collect_mu(active, n_slots: int) -> np.ndarray:
    """[n_slots] f32 mu of a decode block from the streams' carried
    `mirostat_mu`, a mirostat stream's first block starting at 2 * tau.
    `active` yields (slot, stream) pairs."""
    mu = np.zeros(n_slots, np.float32)
    for slot, s in active:
        ds = s.request.device_sampler
        if ds is not None and ds.mirostat and s.mirostat_mu is None:
            s.mirostat_mu = mirostat_mu_init(ds)
        mu[slot] = s.mirostat_mu if s.mirostat_mu is not None else 0.0
    return mu


def store_mu(active, mu_state, keep_by_slot=None) -> None:
    """Carry each mirostat stream's mu out of a decode block: the block's
    final [n_slots] row, or from the trajectory [n_steps, n_slots] (mu after
    each step) the row of the stream's last kept token (`keep_by_slot`:
    its kept count). The block-final mu would fold in the surprises of
    tokens the host drops after an EoT or at max_tokens."""
    mu_state = np.asarray(mu_state)
    for slot, s in active:
        ds = s.request.device_sampler
        if ds is not None and ds.mirostat:
            if mu_state.ndim == 2:
                k = (keep_by_slot[slot] if keep_by_slot is not None
                     else mu_state.shape[0])
                s.mirostat_mu = float(mu_state[k - 1, slot])
            else:
                s.mirostat_mu = float(mu_state[slot])
