"""Host seconds of the `graph.capture` spans of set-up: each CUDA graph's
two eager warm-ups, the capture and its synchronize."""

from portbench.spans import in_setup, seconds


def read(run):
    recs = in_setup(run, "graph.capture")
    if not recs:
        return None
    return sum(seconds(recs))
