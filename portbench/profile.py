"""A profiled slice of a run: the card's operations and the host's ops, and
their reduction to busy time, idle gaps and time by kernel.

The slice runs under `torch.profiler` (CPU and CUDA activities) inside one
`record_function` span, which ends after a synchronize, so the span is the
slice's wall time on the profiler's own clock. Busy time is the union of
the intervals of every operation on the device (kernels, copies, sets)
inside the span (not the host's spans that the profiler mirrors onto the
card's timeline), as `chip_smoke.step_profile` takes it; an idle gap is a
stretch of the span that no device interval covers, named by the
innermost host op that was running when it began.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN = "portbench.slice"


@dataclass
class Trace:
    window_s: float  # the slice on the profiler's clock
    ops: list = field(default_factory=list)  # (start_s, end_s, name), device
    host: list = field(default_factory=list)  # (start_s, end_s, name), host

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.ops))

    def time_by_name(self) -> dict:
        out: dict = {}
        for a, b, name in self.ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def time_matching(self, parts) -> float:
        """Device seconds of the operations whose name holds any of
        `parts`."""
        return sum(b - a for a, b, n in self.ops if any(p in n for p in parts))

    def idle_gaps(self, n: int = 10) -> list:
        """(host op running when the gap began, seconds) of the n longest
        idle stretches, longest first."""
        gaps, t = [], 0.0
        for a, b in _union(self.ops) + [(self.window_s, self.window_s)]:
            if a > t:
                gaps.append((t, a - t))
            t = max(t, b)
        gaps = sorted(gaps, key=lambda g: -g[1])[:n]
        host = sorted(self.host)
        out = []
        for start, length in gaps:
            name = "host"
            best = None
            for a, b, n in host:
                if a > start:
                    break
                if b > start and (best is None or a >= best):
                    best, name = a, n
            out.append((name, length))
        return sorted(out, key=lambda g: -g[1])


def _union(ops) -> list:
    out = []
    for a, b, _ in sorted(ops):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def profiled(fn, device):
    """Run fn() under the profiler; returns (fn's result, Trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            result = fn()
            torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == SPAN)
    s0, s1 = span.start_ns(), span.end_ns()
    ops, host = [], []
    for e in events:
        a, b = max(e.start_ns(), s0), min(e.end_ns(), s1)
        if b <= a or e.name() == SPAN:
            continue
        item = ((a - s0) * 1e-9, (b - s0) * 1e-9, e.name())
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not e.is_user_annotation():  # a host span mirrored on the card
            ops.append(item)
    return result, Trace((s1 - s0) * 1e-9, ops, host)
