"""The traffic generator: a seed repeats its requests, seeds differ in
ids and order, and every period holds the same lengths; over every mix
under traffic/ and a tiny mix of the generator's other distributions."""

import json
from collections import Counter
from pathlib import Path

import pytest

from portbench.tests import tiny
from portbench.traffic import RequestStream, length_set

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"


def mixes():
    return sorted(p.stem for p in TRAFFIC.glob("*.json")) + ["tiny.spread"]


def load(mix):
    if mix == "tiny.spread":
        return tiny.SPREAD
    return json.loads((TRAFFIC / f"{mix}.json").read_text())


@pytest.mark.parametrize("mix", mixes())
def test_a_seed_repeats(mix):
    t = load(mix)
    a = RequestStream(t, 50432, 2**33 + 5)
    b = RequestStream(t, 50432, 2**33 + 5)
    assert [a.get(i) for i in range(3 * t["period"])] == \
        [b.get(i) for i in range(3 * t["period"])]


@pytest.mark.parametrize("mix", mixes())
def test_seeds_differ_but_share_the_lengths(mix):
    t = load(mix)
    n = t["period"]
    a, b = RequestStream(t, 50432, 11), RequestStream(t, 50432, 12)
    ra = [a.get(i) for i in range(2 * n)]
    rb = [b.get(i) for i in range(2 * n)]
    assert [r.prompt for r in ra] != [r.prompt for r in rb]
    for k in range(2):
        la = Counter((len(r.prompt), r.max_tokens) for r in ra[k*n:(k+1)*n])
        lb = Counter((len(r.prompt), r.max_tokens) for r in rb[k*n:(k+1)*n])
        assert la == lb == Counter(length_set(t))


@pytest.mark.parametrize("mix", mixes())
def test_lengths_within_the_mix(mix):
    t = load(mix)
    for p, o in length_set(t):
        assert t["prompt"]["min"] <= p <= t["prompt"]["max"]
        assert t["output"]["min"] <= o <= t["output"]["max"]
        assert (o - t["output"]["min"]) % t["output"].get("step", 1) == 0
    s = RequestStream(t, 100, 3)
    assert all(1 <= tok < 100 for r in (s.get(i) for i in range(20))
               for tok in r.prompt)


def test_lengths_follow_the_distributions():
    ps = sorted(p for p, _ in length_set(tiny.SPREAD))
    assert ps[len(ps) // 2] in range(11, 15)  # median 12
    assert ps[0] == 4 and ps[-1] <= 40
    assert sorted(o for _, o in length_set(tiny.SPREAD)) == \
        [8, 12, 12, 16, 16, 20, 20, 24]


def test_the_interactive_mix_is_the_traces_medians():
    t = load("interactive")
    assert length_set(t) == [(1020, 128)]
    assert "arXiv:2311.18677" in t["source"]
