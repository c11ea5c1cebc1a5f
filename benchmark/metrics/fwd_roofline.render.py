"""fwd_roofline.render: the forward role's least time for the traced views' queries over the
device time of its kernels, in %."""

from benchmark.trace import roofline


def read(t):
    return roofline(t, "fwd")
