"""view_ms_p90: the 90th percentile over the window's views of the time from issuing a
view's rays to its rgb and instance maps on the host, in ms."""

from benchmark.yardstick import percentile


def read(w):
    if w.kind != "view" or not w.unit_s:
        return None
    return 1e3 * percentile(w.unit_s, 90)
