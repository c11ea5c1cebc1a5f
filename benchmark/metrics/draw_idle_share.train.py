"""draw_idle_share.train: the device's idle time while the program's ``train.draw`` span is
open (the sampler's host draws of a pack, its learning rates, uniforms and copy), over the
traced window, in %."""

from benchmark.spans import idle_share_in


def read(t):
    return idle_share_in(t, ["train.draw"])
