"""The program's spans on a ``Trace``'s clock, and the device's idle time inside them: what
the span readers (``metrics/draw_idle_share.train.py``, ``draw_ms_per_step.train.py``,
``chunk_idle_share.render.py``, ``query_idle_share.render.py``) share.

The program (``dmnerf_tpu_torch.utils.spans``) keeps its spans in memory while a profiler
runs, stamped with ``time.time_ns()``. The profiler's Chrome trace counts ``ts`` from
``baseTimeNanoseconds`` on the same clock, and a ``Trace`` counts seconds from that base,
which is learned once a process from a profiler session of one annotation, exported and
read. A program without the spans module (an older checkout) and a window that no span
of the names falls in both read None.
"""

from __future__ import annotations

import importlib
import json
import os
import tempfile
from typing import Iterable, List, NamedTuple, Optional, Tuple

from benchmark import yardstick

_BASE_NS: Optional[int] = None


class Opened(NamedTuple):
    name: str
    start: float            # seconds on the trace's clock, clipped to the window
    end: float
    n: Optional[float]      # the span's count of work, times the share of it in the window


def base_ns() -> int:
    """The profiler's ``baseTimeNanoseconds`` in this process."""
    global _BASE_NS
    if _BASE_NS is None:
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("benchmark.base"):
                pass
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                _BASE_NS = int(json.load(f)["baseTimeNanoseconds"])
        finally:
            os.remove(path)
    return _BASE_NS


def program_records() -> Optional[list]:
    """The program's span records, or None where it has no spans module."""
    try:
        spans = importlib.import_module("dmnerf_tpu_torch.utils.spans")
    except ImportError:
        return None
    return spans.records()


def opened(t, names: Optional[Iterable[str]]) -> Optional[List[Opened]]:
    """The program's spans named ``names`` (None: every name) that fall in the window of
    ``t``, on its clock and clipped to it, in the order they were opened; None where there
    are none or no spans module."""
    recs = program_records()
    if not recs:
        return None
    names, base, out = None if names is None else set(names), base_ns(), []
    for r in recs:
        if names is not None and r.name not in names:
            continue
        s, e = (r.start_ns - base) * 1e-9, (r.end_ns - base) * 1e-9
        if e <= t.t0 or s >= t.t1:
            continue
        cs, ce = max(s, t.t0), min(e, t.t1)
        n = r.n if r.n is None or e <= s else r.n * (ce - cs) / (e - s)
        out.append(Opened(r.name, cs, ce, n))
    return out or None


def gaps(t) -> List[Tuple[float, float]]:
    """The window's stretches with no device activity (``trace.idle_gaps`` finds the same
    ones, but returns only their names)."""
    gaps, at = [], t.t0
    for s, e in yardstick.merge((s, e) for _, s, e in t.device):
        if s > at:
            gaps.append((at, min(s, t.t1)))
        at = max(at, e)
    if t.t1 > at:
        gaps.append((at, t.t1))
    return gaps


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(t, names: Iterable[str]) -> Optional[float]:
    """The device's idle time while a span of ``names`` is open (nested ones once), over
    the window, in %."""
    if t.window_s <= 0 or not t.device:
        return None
    spans = opened(t, names)
    if spans is None:
        return None
    inside = yardstick.merge((s.start, s.end) for s in spans)
    return 100.0 * overlap(gaps(t), inside) / t.window_s


def ms_per_n(t, names: Iterable[str]) -> Optional[float]:
    """The host's ms in the spans of ``names`` (nested ones once) over the sum of their
    counts."""
    if not t.device:
        return None
    spans = opened(t, names)
    if spans is None:
        return None
    n = sum(s.n for s in spans if s.n is not None)
    return 1e3 * yardstick.union_seconds((s.start, s.end) for s in spans) / n if n > 0 else None
