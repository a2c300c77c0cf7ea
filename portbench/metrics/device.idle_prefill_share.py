"""Share of the profiled slice's wall time in which no operation ran on
the card while the host was inside `session.prefill`, in percent. With
`device.idle_blocks_share` it adds up to at most `device.idle_share`.

The slice runs under the profiler, whose cost on each eager op the
prefill's many launches pay: this share holds that cost besides the
port's own idle. Its untraced counterpart is the window's
`session.prefill` seconds less the card's busy seconds inside the
slice's prefill (PERF.md, section 5)."""

from portbench.spans import idle_inside


def read(run):
    return idle_inside(run, "session.prefill")
