"""The quantized matmuls' share of their roofline in the profiled slice
(the session cells): the bound seconds of every projection and output-head
row the slice's tokens needed, over the device seconds of the `qmm_*`
and `sum_splits` kernels, in percent."""

from portbench.readings import QMATMUL, bound_share


def read(run):
    if run.driver != "session":
        return None
    return bound_share(run, "matmul", QMATMUL)
