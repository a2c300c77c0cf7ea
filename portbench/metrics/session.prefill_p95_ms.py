"""95th percentile over the window of the `session.prefill` span: a
request's prompt through `feed_prompt`'s chunks, which ends in the last
chunk's logits readback (a synchronize)."""

from portbench.spans import in_window, seconds


def read(run):
    recs = in_window(run, "session.prefill")
    if not recs:
        return None
    return run.p95([1e3 * s for s in seconds(recs)])
