"""fwd_roofline.train: the forward role's least time for the traced steps' queries over
the device time of its kernels (``roles/*.json`` with role ``fwd``), in %."""

from benchmark.trace import roofline


def read(t):
    return roofline(t, "fwd")
