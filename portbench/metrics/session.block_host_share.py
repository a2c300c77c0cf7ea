"""The window's `session.block.host` seconds (each decode block's host
tail, from its tokens' readback on: EoT scan, detokenize, callback, the
logits' readback) over its `session.request` seconds, in percent: the
part of a request's wall time in which the port holds nothing queued on
the card, read without a profiler."""

from portbench.spans import in_window, seconds


def read(run):
    tails = in_window(run, "session.block.host")
    reqs = in_window(run, "session.request")
    if not tails or not reqs:
        return None
    return 100.0 * sum(seconds(tails)) / sum(seconds(reqs))
