"""Token samplers: the default chain, string DSL, and sampling entry point.

Mirrors llm/crates/llm-base/src/samplers.rs (which wraps the
`llm-samplers` crate v0.0.7). Sampling runs host-side on the final logits
vector — same as the reference — so plain numpy is the right tool; the TPU
owns everything up to the logits.

Default chain order (samplers.rs:75-188):
    flatbias? -> repetition -> freqpresence* -> seqrepetition* -> topk ->
    tailfree -> locallytypical -> topp -> topa -> minp -> temperature ->
    mirostat1|mirostat2|randdistrib

DSL (samplers.rs:229-241): `name:key=val:key2=val2`; names case-insensitive
ignoring `-`/`_`; key prefixes allowed when unambiguous; single-option
samplers take a bare value; multiple configurations separated by space or
`/`. Mirostat 1/2 are incompatible with each other and with
topk/topp/topa/minp/locallytypical/tailfree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import numpy as np


class SamplerConfigurationError(ValueError):
    pass


class SamplingError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# individual samplers. Each transforms logits (f32 [V]) and/or terminates the
# chain by returning a token id.


@dataclass
class SamplerBase:
    def apply(self, logits: np.ndarray, prev: Sequence[int], rng) -> np.ndarray:
        return logits


@dataclass
class FlatBias(SamplerBase):
    bias: Sequence[tuple[int, float]] = ()

    def apply(self, logits, prev, rng):
        for tid, b in self.bias:
            logits[tid] = b if math.isinf(b) and b < 0 else logits[tid] + b
        return logits


@dataclass
class Repetition(SamplerBase):
    """Penalize recently-seen tokens (CTRL-style)."""

    penalty: float = 1.30
    last_n: int = 64

    def apply(self, logits, prev, rng):
        window = prev[-self.last_n :] if self.last_n > 0 else prev
        for tid in set(window):
            l = logits[tid]
            logits[tid] = l * self.penalty if l < 0.0 else l / self.penalty
        return logits


@dataclass
class FreqPresence(SamplerBase):
    frequency: float = 0.0
    presence: float = 0.0
    last_n: int = 64

    def apply(self, logits, prev, rng):
        window = prev[-self.last_n :] if self.last_n > 0 else prev
        if not len(window):
            return logits
        ids, counts = np.unique(np.asarray(window, dtype=np.int64), return_counts=True)
        logits[ids] -= counts * self.frequency + self.presence
        return logits


@dataclass
class SeqRepetition(SamplerBase):
    """Penalize tokens that would extend an already-seen token sequence."""

    last_n: int = 64
    min_length: int = 3
    flat_penalty: float = 0.0
    stacking_penalty: float = 0.0
    tolerance: int = 0
    max_merge: int = 1

    def apply(self, logits, prev, rng):
        if self.flat_penalty == 0.0 and self.stacking_penalty == 0.0:
            return logits
        window = list(prev[-self.last_n :]) if self.last_n > 0 else list(prev)
        n = len(window)
        if n <= self.min_length:
            return logits
        # a continuation token is penalized when the sequence ending just
        # before it matches the tail of the window (excluding the continuation
        # position itself) with length >= min_length
        for e in range(self.min_length - 1, n - 1):
            match_len = 0
            while match_len <= e and window[e - match_len] == window[n - 2 - match_len]:
                match_len += 1
                if match_len >= n - 1:
                    break
            if match_len >= self.min_length:
                tid = window[e + 1]
                logits[tid] -= self.flat_penalty + self.stacking_penalty * match_len
        return logits


@dataclass
class TopK(SamplerBase):
    k: int = 40
    min_keep: int = 1

    def apply(self, logits, prev, rng):
        k = max(self.k, self.min_keep)
        if k <= 0 or k >= logits.size:
            return logits
        thresh = np.partition(logits, -k)[-k]
        logits[logits < thresh] = -np.inf
        return logits


def _probs(logits: np.ndarray) -> np.ndarray:
    m = np.max(logits)
    e = np.exp(logits - m)
    return e / e.sum()


@dataclass
class TailFree(SamplerBase):
    z: float = 1.0
    min_keep: int = 1

    def apply(self, logits, prev, rng):
        if self.z >= 1.0:
            return logits
        order = np.argsort(-logits, kind="stable")
        p = _probs(logits[order])
        if p.size < 3:
            return logits
        d2 = np.abs(np.diff(p, n=2))
        s = d2.sum()
        if s > 0:
            d2 = d2 / s
        cum = np.cumsum(d2)
        keep = int(np.searchsorted(cum, self.z) + 1)
        keep = max(keep, self.min_keep)
        logits[order[keep:]] = -np.inf
        return logits


@dataclass
class LocallyTypical(SamplerBase):
    p: float = 1.0
    min_keep: int = 1

    def apply(self, logits, prev, rng):
        if self.p >= 1.0:
            return logits
        probs = _probs(logits)
        with np.errstate(divide="ignore"):
            nlp = -np.log(probs)
        with np.errstate(invalid="ignore"):  # 0 * inf at zero-prob lanes
            ent = np.nansum(np.where(probs > 0, probs * nlp, 0.0))
        shifted = np.abs(nlp - ent)
        order = np.argsort(shifted, kind="stable")
        cum = np.cumsum(probs[order])
        keep = int(np.searchsorted(cum, self.p) + 1)
        keep = max(keep, self.min_keep)
        logits[order[keep:]] = -np.inf
        return logits


@dataclass
class TopP(SamplerBase):
    p: float = 0.95
    min_keep: int = 1

    def apply(self, logits, prev, rng):
        if self.p >= 1.0:
            return logits
        order = np.argsort(-logits, kind="stable")
        probs = _probs(logits[order])
        cum = np.cumsum(probs)
        keep = int(np.searchsorted(cum, self.p) + 1)
        keep = max(keep, self.min_keep)
        logits[order[keep:]] = -np.inf
        return logits


@dataclass
class TopA(SamplerBase):
    a1: float = 0.0
    a2: float = 0.0
    min_keep: int = 1

    def apply(self, logits, prev, rng):
        if self.a1 == 0.0 and self.a2 == 0.0:
            return logits
        probs = _probs(logits)
        pmax = probs.max()
        limit = self.a1 * (pmax**self.a2)
        mask = probs < limit
        if (~mask).sum() < self.min_keep:
            return logits
        logits[mask] = -np.inf
        return logits


@dataclass
class MinP(SamplerBase):
    p: float = 0.0
    min_keep: int = 1

    def apply(self, logits, prev, rng):
        if self.p <= 0.0:
            return logits
        probs = _probs(logits)
        mask = probs < self.p * probs.max()
        if (~mask).sum() < self.min_keep:
            return logits
        logits[mask] = -np.inf
        return logits


@dataclass
class Temperature(SamplerBase):
    temperature: float = 0.8

    def apply(self, logits, prev, rng):
        if self.temperature > 0:
            logits /= self.temperature
        return logits


@dataclass
class RandDistrib(SamplerBase):
    def sample(self, logits, prev, rng) -> int:
        probs = _probs(logits)
        probs = np.where(np.isfinite(logits), probs, 0.0)
        probs = probs / probs.sum()
        return int(rng.choice(probs.size, p=probs))


@dataclass
class Mirostat1(SamplerBase):
    tau: float = 5.0
    eta: float = 0.1
    m: int = 100
    n_vocab: int = 0
    mu: Optional[float] = None

    def sample(self, logits, prev, rng) -> int:
        if self.mu is None:
            self.mu = 2.0 * self.tau
        n = self.n_vocab or logits.size
        order = np.argsort(-logits, kind="stable")
        probs = _probs(logits[order])
        m = min(self.m, probs.size - 1)
        # estimate the Zipf exponent s_hat from the top-m probabilities
        num = den = 0.0
        for i in range(m - 1):
            t_i = math.log((i + 2) / (i + 1))
            b_i = math.log(probs[i] / probs[i + 1]) if probs[i + 1] > 0 else 0.0
            num += t_i * b_i
            den += t_i * t_i
        s_hat = num / den if den > 0 else 1.0
        eps = s_hat - 1.0
        if eps == 0.0:
            k = probs.size
        else:
            k = ((eps * (2.0**self.mu)) / (1.0 - float(n) ** (-eps))) ** (
                1.0 / s_hat
            )
            k = int(max(1, min(round(k), probs.size)))
        sub = probs[:k]
        sub = sub / sub.sum()
        idx = int(rng.choice(k, p=sub))
        tid = int(order[idx])
        surprise = -math.log2(probs[idx]) if probs[idx] > 0 else 100.0
        self.mu -= self.eta * (surprise - self.tau)
        return tid


@dataclass
class Mirostat2(SamplerBase):
    tau: float = 5.0
    eta: float = 0.1
    mu: Optional[float] = None

    def sample(self, logits, prev, rng) -> int:
        if self.mu is None:
            self.mu = 2.0 * self.tau
        order = np.argsort(-logits, kind="stable")
        probs = _probs(logits[order])
        with np.errstate(divide="ignore"):
            surprises = -np.log2(probs)
        keep = surprises <= self.mu
        if not keep.any():
            keep[0] = True
        sub = probs[keep]
        sub = sub / sub.sum()
        idx = int(rng.choice(sub.size, p=sub))
        tid = int(order[np.flatnonzero(keep)[idx]])
        surprise = float(surprises[np.flatnonzero(keep)[idx]])
        self.mu -= self.eta * (surprise - self.tau)
        return tid


# ---------------------------------------------------------------------------
# the chain


class SamplerChain:
    """Ordered chain; the terminal sampler picks the token."""

    def __init__(self, transforms: list[SamplerBase], terminal):
        self.transforms = transforms
        self.terminal = terminal

    def sample(self, logits: np.ndarray, prev: Sequence[int], rng) -> int:
        if not np.isfinite(logits).any() or np.isnan(logits).any():
            raise SamplingError("logits contain NaN")
        x = np.array(logits, dtype=np.float32, copy=True)
        for t in self.transforms:
            x = t.apply(x, prev, rng)
        return self.terminal.sample(x, prev, rng)


class DeterministicSampler:
    """Greedy + never-repeat: -inf bias on every previously seen token
    (llm-test's determinism trick, binaries/llm-test/src/inference.rs:94-117)."""

    def sample(self, logits, prev, rng) -> int:
        x = np.array(logits, dtype=np.float32, copy=True)
        if len(prev):
            x[np.asarray(list(set(prev)), dtype=np.int64)] = -np.inf
        return int(np.argmax(x))


class GreedySampler:
    def sample(self, logits, prev, rng) -> int:
        return int(np.argmax(logits))


# ---------------------------------------------------------------------------
# DSL

_CHAIN_ORDER = [
    "repetition",
    "freqpresence",
    "seqrepetition",
    "topk",
    "tailfree",
    "locallytypical",
    "topp",
    "topa",
    "minp",
    "temperature",
]

_SAMPLER_CLASSES = {
    "repetition": Repetition,
    "freqpresence": FreqPresence,
    "seqrepetition": SeqRepetition,
    "topk": TopK,
    "tailfree": TailFree,
    "locallytypical": LocallyTypical,
    "topp": TopP,
    "topa": TopA,
    "minp": MinP,
    "temperature": Temperature,
    "mirostat1": Mirostat1,
    "mirostat2": Mirostat2,
}

# samplers whose single primary option can be given without a key
_PRIMARY_OPTION = {
    "temperature": "temperature",
    "topk": "k",
    "topp": "p",
    "minp": "p",
    "locallytypical": "p",
    "tailfree": "z",
}

_MIROSTAT_INCOMPAT = {"topa", "minp", "topp", "topk", "locallytypical", "tailfree"}


def _parse_value(v: str):
    try:
        return int(v)
    except ValueError:
        return float(v)


def _configure(name: str, args: str):
    cls = _SAMPLER_CLASSES[name]
    obj = cls()
    field_names = [f.name for f in fields(cls) if f.name != "mu"]
    for part in filter(None, args.split(":")):
        if "=" in part:
            key, val = part.split("=", 1)
            key = key.strip()
            matches = [f for f in field_names if f.startswith(key)]
            if len(matches) != 1:
                raise SamplerConfigurationError(
                    f"sampler {name}: ambiguous or unknown option {key!r}"
                )
            setattr(obj, matches[0], _parse_value(val.strip()))
        else:
            primary = _PRIMARY_OPTION.get(name)
            if primary is None:
                raise SamplerConfigurationError(
                    f"sampler {name} requires key=value options"
                )
            setattr(obj, primary, _parse_value(part.strip()))
    return obj


def build_sampler_chain(
    args: Sequence[str] = (),
    n_vocab: int = 0,
    bias: Sequence[tuple[int, float]] = (),
) -> SamplerChain:
    """build_sampler analog (samplers.rs:314-344)."""
    configured: dict[str, list] = {}
    mirostat1 = mirostat2 = False
    incompat = False

    text = " ".join(a.strip() for a in args if a.strip())
    for item in text.replace("/", " ").split():
        if ":" in item:
            raw_name, opts = item.split(":", 1)
        else:
            raw_name, opts = item, ""
        name = raw_name.strip().lower().replace("_", "").replace("-", "")
        if name not in _SAMPLER_CLASSES:
            raise SamplerConfigurationError(f"unknown sampler {raw_name!r}")
        if name == "mirostat1":
            mirostat1 = True
        elif name == "mirostat2":
            mirostat2 = True
        elif name in _MIROSTAT_INCOMPAT:
            incompat = True
        configured.setdefault(name, []).append(_configure(name, opts))

    if mirostat1 and mirostat2:
        raise SamplerConfigurationError(
            "Cannot enable both Mirostat 1 and Mirostat 2 samplers"
        )
    if (mirostat1 or mirostat2) and incompat:
        raise SamplerConfigurationError(
            "Cannot enable top-p, top-k, top-a, min-p, locally typical or "
            "tail free samplers with Mirostat 1 or 2"
        )
    mirostat = mirostat1 or mirostat2

    # ensure_default_slots (samplers.rs:193-210)
    configured.setdefault("repetition", [Repetition()])
    configured.setdefault("temperature", [Temperature()])
    if not mirostat:
        configured.setdefault("topk", [TopK()])
        configured.setdefault("topp", [TopP()])

    transforms: list[SamplerBase] = []
    if bias:
        transforms.append(FlatBias(bias=list(bias)))
    for name in _CHAIN_ORDER:
        transforms.extend(configured.get(name, []))

    if mirostat1:
        term = configured["mirostat1"][0]
        term.n_vocab = n_vocab
    elif mirostat2:
        term = configured["mirostat2"][0]
    else:
        term = RandDistrib()
    return SamplerChain(transforms, term)


def default_samplers() -> SamplerChain:
    return build_sampler_chain()


def sample_token(
    sampler,
    rng: np.random.Generator,
    previous_tokens: Sequence[int],
    last_logits: np.ndarray,
) -> int:
    """sample_token analog (samplers.rs:289-306)."""
    logits = np.asarray(last_logits, dtype=np.float32)
    if np.isnan(logits).any():
        raise SamplingError("logits contain NaN")
    return sampler.sample(logits, previous_tokens, rng)
