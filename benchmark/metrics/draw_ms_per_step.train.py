"""draw_ms_per_step.train: the host's ms in the program's ``train.draw`` spans of the traced
window over the steps they drew."""

from benchmark.spans import ms_per_n


def read(t):
    return ms_per_n(t, ["train.draw"])
