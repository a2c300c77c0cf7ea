"""Whether what the timed path served is right: the served tokens of a
sample of the window's finished requests, held against the plain
reference run over each prompt with its served tokens.

The number compared is the widest gap by which a served token's logit
lies below the reference's best at its position (a banned token is out of
the reference's choice, as it was out of the program's). Greedy decoding
that computes what the reference computes serves its best token, gap 0,
except where rounding flips a near tie. The control reads, at the same
positions, the gap of the token that the reference computed in the
control's lower precision puts first.
"""

from __future__ import annotations

import numpy as np
import torch


def pick(recs: list, seed: int, requests: int) -> list:
    """The longest finished request, then others drawn from the seed, up
    to `requests` in all: each request's first served token follows a
    fresh prompt, where a random model's greedy output has not yet
    settled into repeating itself."""
    done = [r for r in recs if r.ok and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.index))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 7]).permutation(len(rest))
    out = [longest]
    out += [rest[int(i)] for i in order[:requests - 1]]
    return out


def _mask(logits: torch.Tensor, banned) -> torch.Tensor:
    if banned:
        logits = logits.clone()
        logits[:, list(banned)] = float("-inf")
    return logits


def _gaps(logits: torch.Tensor, toks) -> torch.Tensor:
    """best logit - the logit of toks, at each position."""
    t = torch.as_tensor(toks, dtype=torch.long, device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]


def compare(ref, recs: list, banned=(), control=None) -> dict:
    """Run the reference over each request's prompt and served tokens but
    the last, and read at each served token's position: `max_gap`, the
    widest gap of a served token below the reference's best;
    `median_margin`, the median of the reference's top-1 minus top-2 (how
    near the ties are that rounding can flip); with a `control` reference,
    `control_gap`, the widest gap of the control's first choice."""
    seqs = [list(r.prompt) + r.tokens[:-1] for r in recs]
    rows = [list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.tokens)))
            for r in recs]
    choice = None
    if control is not None:
        choice = control.logits(
            seqs, rows, lambda i, lg: _mask(lg, banned).argmax(-1))

    def reduce(i, lg):
        lg = _mask(lg, banned)
        top = lg.topk(2, dim=-1).values
        out = (float(_gaps(lg, recs[i].tokens).max()),
               (top[:, 0] - top[:, 1]).cpu())
        if choice is not None:
            out += (float(_gaps(lg, choice[i]).max()),)
        return out

    got = ref.logits(seqs, rows, reduce)
    res = {"max_gap": max(g[0] for g in got),
           "median_margin": float(torch.cat([g[1] for g in got]).median())}
    if choice is not None:
        res["control_gap"] = max(g[2] for g in got)
    return res
