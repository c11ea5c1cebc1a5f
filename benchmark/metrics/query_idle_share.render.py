"""query_idle_share.render: the device's idle time while the program's ``query`` span is
open (the fused point query's host side: packing its inputs, launching its kernels), over
the traced window, in %."""

from benchmark.spans import idle_share_in


def read(t):
    return idle_share_in(t, ["query"])
