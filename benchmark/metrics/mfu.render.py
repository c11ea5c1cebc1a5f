"""mfu.render: the analytic FLOPs the traced views need (``yardstick.point_flops`` of each
query's model) over the traced window's seconds, as a share of the card's dense bf16 peak,
in %."""

from benchmark.trace import share_of_peak


def read(t):
    return share_of_peak(t, t.work["flops"]) if t.work.get("views") else None
