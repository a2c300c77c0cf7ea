"""A run with the timed path broken underneath comes out as not correct:
the harness's look for a chip skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault the session cell can have: a step
that leaves its state unchanged, half of a prefill batch's rows left out
of the cache, a token altered where it is produced. (One card, so no
exchange between chips.)"""

import pytest

from portbench.run import run_cell
from portbench.tests import tiny


def _alter_session_token():
    from llm_tpu_torch.models import forward

    orig = forward.decode_loop

    def patched(*a, **k):
        out = list(orig(*a, **k))
        out[0] = out[0].clone()
        out[0][0] = out[0][0] % (a[0].n_vocab - 1) + 1
        return tuple(out)

    return forward, "decode_loop", patched


def _drop_cache_writes():
    from llm_tpu_torch.models import forward

    return forward, "write_cache_batched", lambda cache, *a, **k: cache


def _drop_half_the_prefill_rows():
    """A prefill chunk writes the first half of its rows only; the decode
    (one row) writes as it should."""
    from llm_tpu_torch.models import forward

    orig = forward.write_cache_batched

    def patched(cache, k_news, v_news, *a, **k):
        T = k_news[0].shape[1]
        if T > 1:
            k_news = [x[:, :T // 2] for x in k_news]
            v_news = [x[:, :T // 2] for x in v_news]
        return orig(cache, k_news, v_news, *a, **k)

    return forward, "write_cache_batched", patched


FAULTS = {
    "state_unchanged": _drop_cache_writes,
    "half_batch": _drop_half_the_prefill_rows,
    "token": _alter_session_token,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault]())
    # every finished request of the window checked
    traffic = {**tiny.INTERACTIVE,
               "check": {**tiny.INTERACTIVE["check"], "requests": 1000}}
    out = run_cell(tiny.FALCON, traffic, tiny.LIMITS, [], 11, 1.0, False,
                   "cpu")
    assert not out["correct"]
    gap = out["checks"]["max_logit_gap"]["value"]
    assert gap is None or gap > tiny.LIMITS["max_logit_gap"]


def test_the_unbroken_path_is_correct():
    out = run_cell(tiny.FALCON, tiny.INTERACTIVE, tiny.LIMITS, [], 11, 2.0,
                   False, "cpu")
    assert out["correct"], out["checks"]
