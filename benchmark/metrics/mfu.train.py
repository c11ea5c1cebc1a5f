"""mfu.train: the analytic FLOPs of the traced train steps (``yardstick.train_step_flops``)
over the traced window's seconds, as a share of the card's dense bf16 peak, in %."""

from benchmark.trace import share_of_peak


def read(t):
    return share_of_peak(t, t.work["flops"]) if t.work.get("steps") else None
