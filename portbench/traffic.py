"""The one generator of requests, driven by a traffic file's parameters.

Lengths come as a fixed set a period long: `period` prompt lengths at the
distribution's quantiles (i + 0.5) / period, each paired with an output
length by a fixed permutation. A distribution is "fixed" (every length
`value`), "uniform" or "lognormal" (`median`, `sigma`), clipped to `min`
and `max` and rounded to a multiple of `step` above `min`. Every seed gets that same set in every
period, in its own order, so runs of different seeds do the same work;
the seed also draws the token ids. A request stream is the concatenation
of such periods, handed to clients in the order they ask.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass(frozen=True)
class Request:
    index: int
    prompt: tuple  # token ids
    max_tokens: int


def _quantiles(dist: dict, n: int) -> list[int]:
    lo, hi = dist["min"], dist["max"]
    step = dist.get("step", 1)
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "fixed":
            x = dist["value"]
        elif dist["dist"] == "lognormal":
            x = math.exp(math.log(dist["median"])
                         + dist["sigma"] * NormalDist().inv_cdf(u))
        elif dist["dist"] == "uniform":
            x = lo + u * (hi - lo)
        else:
            raise ValueError(f"no distribution {dist['dist']!r}")
        x = min(max(x, lo), hi)
        out.append(int(min(max(lo + round((x - lo) / step) * step, lo), hi)))
    return out


def length_set(traffic: dict) -> list[tuple[int, int]]:
    """The period's (prompt length, output length) pairs, the same for
    every seed."""
    n = traffic["period"]
    prompts = _quantiles(traffic["prompt"], n)
    outputs = _quantiles(traffic["output"], n)
    perm = np.random.default_rng(0).permutation(n)
    return [(prompts[i], outputs[int(perm[i])]) for i in range(n)]


class RequestStream:
    """Requests in order, made lazily from the seed: period k is the
    length set shuffled by (seed, k); ids uniform over [1, n_vocab) (0 is
    the end of text)."""

    def __init__(self, traffic: dict, n_vocab: int, seed: int):
        self.pairs = length_set(traffic)
        self.n_vocab = n_vocab
        self.seed = int(seed)
        self._made: list[Request] = []

    def _period(self, k: int) -> list[Request]:
        rng = np.random.default_rng([self.seed, k])
        order = rng.permutation(len(self.pairs))
        out = []
        for j in order:
            p, o = self.pairs[int(j)]
            ids = rng.integers(1, self.n_vocab, size=p)
            out.append(Request(len(self._made) + len(out),
                               tuple(int(t) for t in ids), o))
        return out

    def get(self, i: int) -> Request:
        while len(self._made) <= i:
            self._made += self._period(len(self._made) // len(self.pairs))
        return self._made[i]

    def maxima(self) -> tuple[int, int]:
        """The longest prompt and output any request can have."""
        return (max(p for p, _ in self.pairs), max(o for _, o in self.pairs))

    def minima(self) -> tuple[int, int]:
        return (min(p for p, _ in self.pairs), min(o for _, o in self.pairs))
