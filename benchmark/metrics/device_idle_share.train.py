"""device_idle_share.train: 1 - the union of the device's activity over the traced window,
in %."""

from benchmark.trace import idle_share


def read(t):
    return idle_share(t) if t.work.get("steps") else None
