"""The window's arithmetic on synthetic timelines."""

import pytest

from portbench.window import Rec, Timeline, p95


def _tl(recs, events, t_open=10.0, t_end=20.0, t_cap=50.0):
    tl = Timeline(recs=recs, events=events, t_open=t_open, t_end=t_end,
                  t_cap=t_cap)
    return tl


def _rec(i, sent, first, done, n, error=None):
    return Rec(i, sent, n, (1, 2), first, done, list(range(n)), error)


def test_rate_counts_tokens_inside_the_window_only():
    events = [(9.0, 100), (10.5, 40), (15.0, 60), (20.0, 50), (20.5, 999)]
    tl = _tl([], events)
    assert tl.tokens() == 150
    assert tl.gen_tok_s() == pytest.approx(15.0)


def test_sample_is_the_requests_sent_inside():
    recs = [_rec(0, 9.0, 9.5, 12.0, 10), _rec(1, 10.0, 10.2, 11.0, 5),
            _rec(2, 19.9, 20.5, 22.0, 3), _rec(3, 20.0, 21.0, 22.0, 4)]
    assert [r.index for r in _tl(recs, []).sample()] == [1, 2]


def test_tails_show_a_stall():
    recs = [_rec(i, 10.0 + 0.1 * i, 10.0 + 0.1 * i + 0.05,
                 10.0 + 0.1 * i + 1.05, 11) for i in range(40)]
    tl = _tl(recs, [])
    assert p95(tl.ttft_ms()) == pytest.approx(50.0)
    assert p95(tl.tpot_ms()) == pytest.approx(100.0)
    # a stall of 2 s holds up the first tokens of three requests
    for r in recs[10:13]:
        r.t_first += 2.0
        r.t_done += 2.0
    assert p95(tl.ttft_ms()) > 1000.0
    assert p95(tl.tpot_ms()) == pytest.approx(100.0)


def test_failed_requests_count_and_are_censored_at_the_cap():
    recs = [_rec(0, 11.0, 11.1, 12.0, 5),
            _rec(1, 12.0, None, None, 0),
            _rec(2, 13.0, 13.1, 14.0, 5, error="kv_oom")]
    tl = _tl(recs, [])
    assert [r.index for r in tl.failed()] == [1, 2]
    assert sorted(tl.ttft_ms())[-1] == pytest.approx(1e3 * (50.0 - 12.0))
    assert len(tl.tpot_ms()) == 1


def test_p95_of_few_and_none():
    assert p95([]) is None
    assert p95([7.0]) == 7.0
    assert p95(list(range(1, 101))) == pytest.approx(95.05)
