"""Number of `graph.capture` spans that start in the window. The warm-up
captures every key the traffic can reach, so any capture here means a key
changed inside the window."""

from portbench.spans import in_window


def read(run):
    recs = in_window(run, "graph.capture", session=False)
    return None if recs is None else len(recs)
