"""What the metric readers under `metrics/` share: a share of a bound, in
percent, from a profiled slice. A reader that finds nothing to read
returns None, and the run leaves its metric out."""

from __future__ import annotations

# kernel names (substrings of the profiler's names) of each kernel family
QMATMUL = ("qmm_", "sum_splits")
ATTENTION = ("paged_decode", "gqa_mma")


def bound_share(run, part: str, kernels=None):
    """100 x the slice's bound seconds of `part` (roofline.Work.bounds)
    over the device seconds of `kernels`, or over the slice's wall time
    when `kernels` is None."""
    if run.trace is None or run.work is None or run.peaks is None:
        return None
    bound = run.work.bounds(run.shape, run.peaks)[part]
    took = (run.trace.window_s if kernels is None
            else run.trace.time_matching(kernels))
    if bound <= 0 or took <= 0:
        return None
    return 100.0 * bound / took
