"""bwd_roofline.train: the backward role's least time (twice the forward's products) for
the traced steps' queries over the device time of its kernels, in %."""

from benchmark.trace import roofline


def read(t):
    return roofline(t, "bwd")
