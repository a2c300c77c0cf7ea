"""Tracing and timing instrumentation.

The counterpart of `llm_tpu/trace.py`:

- `span(name, level)`: a context manager that times a block on the host
  clock, accumulates its total and count (always, cheaply) and logs the
  duration to stderr when LLM_TPU_TRACE >= level (1 = spans; 2 = also the
  finer ones: a session evaluation `evaluate[n]`, a decode block and its
  host tail). While a profiler runs the block is also a
  `torch.profiler.record_function` range, so spans show up by name in a
  `profile` trace, on the device trace's clock.
- `records(t0, t1, name)`: every closed span is also kept, whatever the
  level, in a bounded buffer (the newest `RECORDS_MAX`) as a `Record`:
  its name, start and end on `time.monotonic`.
- `profile(log_dir)`: a `torch.profiler.profile` of the block, CPU and
  (when a card is present) CUDA activity, written into `log_dir` as a
  Chrome trace (`trace.json`; open it in chrome://tracing or Perfetto).
- `report()` / `reset()`: the accumulated totals, in the reference's
  InferenceStats style.

The spans the port opens, and their levels:

| Span | Level | Around |
|---|---|---|
| `session.request` | 1 | a whole `InferenceSession.infer` or `infer_device` |
| `session.prefill` | 1 | `feed_prompt`'s chunk loop |
| `evaluate[n]` | 2 | one chunk of n tokens through `_evaluate` |
| `session.block` | 2 | one block of `infer_device`: its state, `decode_loop`, the tokens' readback and the host tail |
| `session.block.host` | 2 | a block's host tail, from its tokens' readback on: EoT scan, detokenize, callback, the logits' readback |
| `graph.capture` | 1 | `forward._capture`: a CUDA graph's warm-ups and capture |
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

_LEVEL = int(os.environ.get("LLM_TPU_TRACE", "0") or "0")

totals: dict[str, float] = defaultdict(float)
counts: dict[str, int] = defaultdict(int)


class Record(NamedTuple):
    """One closed span; times are `time.monotonic()` seconds."""

    name: str
    start: float
    end: float


RECORDS_MAX = 1 << 16
_records: deque = deque(maxlen=RECORDS_MAX)


def enabled(level: int = 1) -> bool:
    return _LEVEL >= level


def set_level(level: int) -> None:
    global _LEVEL
    _LEVEL = level


@contextlib.contextmanager
def span(name: str, level: int = 1) -> Iterator[None]:
    """Timed span; logs to stderr at LLM_TPU_TRACE >= level and accumulates
    totals/counts and its `Record` either way (cheap)."""
    import torch

    t0 = time.monotonic()
    try:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        t1 = time.monotonic()
        dt = t1 - t0
        totals[name] += dt
        counts[name] += 1
        _records.append(Record(name, t0, t1))
        if _LEVEL >= level:
            print(f"[trace] {name}: {dt * 1e3:.2f} ms", file=sys.stderr)


def records(t0: Optional[float] = None, t1: Optional[float] = None,
            name: Optional[str] = None) -> list:
    """The kept `Record`s that start in [t0, t1] (either end open when
    None), of `name` when given, in the order they closed."""
    return [r for r in list(_records)
            if (t0 is None or r.start >= t0) and (t1 is None or r.start <= t1)
            and (name is None or r.name == name)]


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
    _records.clear()
