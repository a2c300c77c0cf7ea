"""Tracing and timing instrumentation.

The counterpart of `llm_tpu/trace.py`:

- `span(name, level)`: a context manager that times a block on the host
  clock, accumulates its total and count (always, cheaply) and logs the
  duration to stderr when LLM_TPU_TRACE >= level (1 = spans; 2 = also one
  line a session evaluation, `evaluate[n]`). Inside it the block is a
  `torch.profiler.record_function` range, so spans show up by name in a
  `profile` trace.
- `profile(log_dir)`: a `torch.profiler.profile` of the block, CPU and
  (when a card is present) CUDA activity, written into `log_dir` as a
  Chrome trace (`trace.json`; open it in chrome://tracing or Perfetto).
- `report()` / `reset()`: the accumulated totals, in the reference's
  InferenceStats style.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator

_LEVEL = int(os.environ.get("LLM_TPU_TRACE", "0") or "0")

totals: dict[str, float] = defaultdict(float)
counts: dict[str, int] = defaultdict(int)


def enabled(level: int = 1) -> bool:
    return _LEVEL >= level


def set_level(level: int) -> None:
    global _LEVEL
    _LEVEL = level


@contextlib.contextmanager
def span(name: str, level: int = 1) -> Iterator[None]:
    """Timed span; logs to stderr at LLM_TPU_TRACE >= level and accumulates
    totals/counts either way (cheap)."""
    import torch.profiler

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        totals[name] += dt
        counts[name] += 1
        if _LEVEL >= level:
            print(f"[trace] {name}: {dt * 1e3:.2f} ms", file=sys.stderr)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Profile the block with torch.profiler and write a Chrome trace to
    `log_dir`/trace.json (the directory is created)."""
    import torch
    from torch.profiler import ProfilerActivity

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def report() -> str:
    """Accumulated span totals, reference InferenceStats style."""
    lines = []
    for name in sorted(totals):
        n = counts[name]
        tot = totals[name]
        lines.append(
            f"{name}: total {tot * 1e3:.1f} ms, calls {n}, "
            f"mean {tot / n * 1e3:.2f} ms"
        )
    return "\n".join(lines)


def reset() -> None:
    totals.clear()
    counts.clear()
