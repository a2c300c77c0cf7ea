"""A run's timeline and the arithmetic of its window: rates and tails.

Times are host seconds (`time.monotonic`). A token counts when the host
holds it: at the end of the call that returned it. The window opens at
`t_open` and ends at `t_end`, the end of the first call that ends at or
after the nominal close, so it holds whole calls: its tokens are every
token returned inside it, over its whole length. Requests sent inside the
window are its sample; after it they run on, up to a cap, and one that
has not finished by then, or that ended in an error, is failed. A failed
request's time to first token is censored at the cap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from statistics import quantiles
from typing import Optional


@dataclass
class Rec:
    """One request's life."""

    index: int
    t_sent: float
    max_tokens: int
    prompt: tuple
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    tokens: list = field(default_factory=list)  # served token ids
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.t_done is not None and self.error is None


def p95(xs: list) -> Optional[float]:
    """The 95th percentile, by `statistics.quantiles`' inclusive method."""
    if not xs:
        return None
    if len(xs) == 1:
        return float(xs[0])
    return float(quantiles(xs, n=20, method="inclusive")[-1])


@dataclass
class Timeline:
    recs: list = field(default_factory=list)
    events: list = field(default_factory=list)  # (t, tokens delivered)
    t_open: Optional[float] = None
    t_end: Optional[float] = None
    t_cap: Optional[float] = None

    def deliver(self, t: float, n: int) -> None:
        if n:
            self.events.append((t, n))

    def sample(self) -> list:
        """The requests sent inside the window."""
        return [r for r in self.recs if self.t_open <= r.t_sent < self.t_end]

    def failed(self) -> list:
        return [r for r in self.sample() if not r.ok]

    def seconds(self) -> float:
        return self.t_end - self.t_open

    def tokens(self) -> int:
        return sum(n for t, n in self.events if self.t_open < t <= self.t_end)

    def gen_tok_s(self) -> float:
        return self.tokens() / self.seconds()

    def ttft_ms(self) -> list:
        out = []
        for r in self.sample():
            first = r.t_first if r.ok else self.t_cap
            out.append(1e3 * (first - r.t_sent))
        return out

    def tpot_ms(self) -> list:
        return [1e3 * (r.t_done - r.t_first) / (len(r.tokens) - 1)
                for r in self.sample() if r.ok and len(r.tokens) > 1]
