"""The whole step's share of the card's peak in the profiled slice (the
session cells): the bound seconds of all the slice's work (every call's
matmuls and attention, each call at the larger of its operations over
the peak rate and its bytes over the bandwidth) over the slice's wall
time, in percent. It still bounds a gain once a kernel leaves the path."""

from portbench.readings import bound_share


def read(run):
    if run.driver != "session":
        return None
    return bound_share(run, "step")
