"""What the span readers under `metrics/` share: the port's records of its
own spans (`llm_tpu_torch.trace.records`, on the Timeline's clock) that
start in a run's window or its set-up, and the card's idle time inside the
host ranges of one span in the profiled slice.

Window spans start in [t_open, t_end]; set-up spans in [t_open - setup_s,
t_open], so an earlier run's spans in the same process never count. A
port that keeps no records, and a run with no window or no slice, give
None: the run leaves the metric out."""

from __future__ import annotations

from portbench.profile import _union


def recorded(t0: float, t1: float, name: str):
    """The port's records of `name` that start in [t0, t1], or None where
    the port keeps none."""
    from llm_tpu_torch import trace

    records = getattr(trace, "records", None)
    return None if records is None else records(t0, t1, name)


def in_window(run, name: str, session: bool = True):
    """Records of `name` that start in the window; None for a session span
    (`session`) where the cell's driver is not the session's."""
    if session and run.driver != "session":
        return None
    if run.tl.t_open is None or run.tl.t_end is None:
        return None
    return recorded(run.tl.t_open, run.tl.t_end, name)


def in_setup(run, name: str):
    """Records of `name` that start in set-up."""
    if run.tl.t_open is None:
        return None
    return recorded(run.tl.t_open - run.setup_s, run.tl.t_open, name)


def seconds(recs) -> list:
    return [r.end - r.start for r in recs]


def idle_inside(run, name: str):
    """100 x the profiled slice's idle seconds (no device operation
    running) inside the host ranges of span `name`, over the slice's wall
    time; None without a slice or without such a range in it."""
    if run.driver != "session" or run.trace is None \
            or run.trace.window_s <= 0:
        return None
    ranges = _union([h for h in run.trace.host if h[2] == name])
    if not ranges:
        return None
    busy = _union(run.trace.ops)
    idle = 0.0
    for a, b in ranges:
        covered = sum(max(0.0, min(b, d) - max(a, c)) for c, d in busy)
        idle += (b - a) - covered
    return 100.0 * idle / run.trace.window_s
