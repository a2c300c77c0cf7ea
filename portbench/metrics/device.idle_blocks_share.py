"""Share of the profiled slice's wall time in which no operation ran on
the card while the host was inside a `session.block` (a decode block and
its host tail), in percent.

The slice runs under the profiler, whose buffer handling and cost on
each launch fall inside the blocks too: this share holds that cost
besides the port's own idle. Its untraced counterpart is the window's
`session.block` seconds less the card's busy seconds inside the slice's
blocks, of which `session.block_host_share` is the host tail (PERF.md,
section 5)."""

from portbench.spans import idle_inside


def read(run):
    return idle_inside(run, "session.block")
