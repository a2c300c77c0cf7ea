"""95th percentile over the session's window requests of (finish - first
token) / (tokens - 1)."""


def read(run):
    if run.driver != "session":
        return None
    return run.p95(run.tl.tpot_ms())
