"""Named spans of the program's host work, recorded only while a ``torch.profiler`` runs.

``with span("render.chunk", n=rays): ...`` marks a stretch of host code. While no
profiler runs (``torch.autograd.profiler._is_profiler_enabled``, which torch sets when
any profiler starts, whatever it records), ``span`` returns one shared object that does
nothing: a span then costs one read of that flag. While one runs, the span appends on
closing a ``Record`` to an in-memory buffer: its name, its start and end on
``time.time_ns()`` (the clock of the profiler's exported Chrome trace:
``baseTimeNanoseconds`` plus ``ts``), the index of the enclosing open span (-1 for none),
the index of the outermost one (its unit: a draw, a replay, a chunk) and its count of
work ``n``. Indices count the spans opened in this process. ``records()`` returns the
buffer in opening order, ``clear()`` empties it, and the buffer keeps the last
``MAX_RECORDS``. A span opens no ``record_function``: torch tells of a running profiler
that it runs, not whether it records the host, and the benchmark's traced stretch, which
reads the records, records the device alone. ``write_chrome_trace`` adds the records to a
trace the profiler exported, as ``user_annotation`` events (``train.profile_dir``).

The program's spans, which the benchmark's span metrics read (``benchmark/spans.py``;
``train.replay`` its clock check, ``train.eager`` a ``profile_dir`` trace's step):

 * ``render.packing.StepRunner``: ``train.draw`` (n: the steps drawn) when a call draws
   its own pack, then ``train.replay`` (a pack's CUDA graph) or ``train.eager`` (n: the
   steps run), then, for a pack of P > 1, ``train.draw`` around the next pack's draw
   made ahead while the replay runs (its generators put back after it);
 * ``render.renderer``: ``render.chunk`` (n: the chunk's real rays), one a chunk;
 * ``render.manipulator``: ``mani.chunk`` (n: the chunk's real rays), one a chunk;
 * ``core.pipeline``'s fused query: ``query`` (n: points), one a point query, inside a
   chunk or an eager step.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int             # the enclosing open span's index, -1 for none
    unit: int               # the outermost open span's index (its own when outermost)
    n: Optional[int]        # the span's count of work
    index: int


_buffer: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_opened = itertools.count()
_stack: list = []           # the open spans, outermost first


class _Off:
    """The span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "index", "parent", "unit", "start_ns")

    def __init__(self, name: str, n: Optional[int]):
        self.name, self.n = name, n

    def __enter__(self):
        self.index = next(_opened)
        self.parent = _stack[-1].index if _stack else -1
        self.unit = _stack[0].index if _stack else self.index
        _stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _stack.pop()
        _buffer.append(Record(self.name, self.start_ns, end_ns, self.parent, self.unit,
                              self.n, self.index))
        return None


def span(name: str, n: Optional[int] = None):
    """A context manager around a stretch of host code (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, n)


def records() -> List[Record]:
    """The closed spans in the buffer, in the order they were opened."""
    return sorted(_buffer, key=lambda r: r.index)


def clear() -> None:
    _buffer.clear()


def write_chrome_trace(path: str) -> int:
    """Add the buffer's records to the Chrome trace a profiler exported at ``path``, as
    ``user_annotation`` events of this thread placed by the trace's
    ``baseTimeNanoseconds``, then empty the buffer; returns the events added."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    pid, tid = os.getpid(), threading.get_native_id()
    recs = records()
    trace["traceEvents"] += [
        {"ph": "X", "cat": "user_annotation", "name": r.name, "pid": pid, "tid": tid,
         "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"n": r.n}} for r in recs]
    with open(path, "w") as f:
        json.dump(trace, f)
    clear()
    return len(recs)
