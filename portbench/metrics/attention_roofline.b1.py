"""Decode attention's share of its roofline in the profiled slice (the
session cells): the bound seconds of the cached rows, queries and outputs
the slice's decode steps needed, over the device seconds of the
`paged_decode` and `gqa_mma` kernels, in percent."""

from portbench.readings import ATTENTION, bound_share


def read(run):
    if run.driver != "session":
        return None
    return bound_share(run, "decode_attention", ATTENTION)
