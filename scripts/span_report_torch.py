"""Run one benchmark cell traced, as ``python3 -m benchmark.run ... --trace 1`` does, then
report what the program's spans show in the stretch its per-layer metrics read.

    python3 scripts/span_report_torch.py --workload <cell> --seed <n> --seconds 30 [--out FILE]

Prints the benchmark's own result line, then one JSON line (also appended to ``--out``):
``idle_by_span``, the device's idle time in the stretch by the innermost span open (in %
of the stretch, adding up to ``device_idle_share``); ``idle_share``, that share itself;
``spans``, the spans of each name in the stretch; ``graph_launches`` and
``replay_misfit_us``, the ``cudaGraphLaunch`` runtime calls of the stretch and the largest
time any of them lies outside every ``train.replay`` span on the span helper's clock;
``captures``, the stretch's runtime calls that begin a stream capture or instantiate a
graph; ``base_ns``, the helper's base, and ``trace_base_ns``, the stretch's own exported
``baseTimeNanoseconds``. The stretch is caught by wrapping ``benchmark.run.traced`` and
``benchmark.trace.read_chrome_trace``, whose first calls are the metrics' stretch.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import json
import sys
from collections import Counter, defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run, spans as bspans, trace as btrace  # noqa: E402

OUTSIDE = "(outside every span)"
CAPTURE_CALLS = ("cudaStreamBeginCapture", "cudaGraphInstantiate")


def misfit_s(calls, replays) -> float:
    """The largest time a call (start, end) lies outside every replay span (start, end)."""
    worst = 0.0
    for s, e in calls:
        worst = max(worst, min((max(0.0, rs - s) + max(0.0, e - re) for rs, re in replays),
                               default=float("inf")))
    return worst


def idle_by_innermost(t):
    """The device's idle time in the window by the innermost program span open at each
    moment of it (``OUTSIDE`` where none is), in % of the window: the shares add up to the
    device's idle share. None where no span falls in the window."""
    if t.window_s <= 0 or not t.device:
        return None
    spans = bspans.opened(t, None)
    if spans is None:
        return None
    cuts = sorted({x for s in spans for x in (s.start, s.end)})
    pieces = []
    for a, b in bspans.gaps(t):
        i = bisect.bisect_right(cuts, a)
        while i < len(cuts) and cuts[i] < b:
            pieces.append((a, cuts[i]))
            a, i = cuts[i], i + 1
        pieces.append((a, b))
    order = sorted(range(len(spans)), key=lambda k: (spans[k].start, k))
    heap: list = []         # (-start, -opening order, end, name): the innermost on top
    at, out = 0, defaultdict(float)
    for a, b in pieces:     # in time order, so a span that ended stays ended
        mid = 0.5 * (a + b)
        while at < len(order) and spans[order[at]].start <= mid:
            k = order[at]
            heapq.heappush(heap, (-spans[k].start, -k, spans[k].end, spans[k].name))
            at += 1
        while heap and heap[0][2] < mid:
            heapq.heappop(heap)
        out[heap[0][3] if heap else OUTSIDE] += b - a
    return {k: 100.0 * v / t.window_s for k, v in out.items()}


def report(stretch, trace_base) -> dict:
    _, device, host, (t0, t1) = stretch
    t = btrace.Trace(conf={}, kind="", work={}, roles={}, device=device, host=host, t0=t0, t1=t1)
    opened = bspans.opened(t, None) or []
    launches = [(s, e) for n, s, e in host if n == "cudaGraphLaunch"]
    replays = [(s.start, s.end) for s in opened if s.name == "train.replay"]
    return {"idle_share": btrace.idle_share(t), "idle_by_span": idle_by_innermost(t),
            "spans": dict(Counter(s.name for s in opened)),
            "graph_launches": len(launches),
            "replay_misfit_us": 1e6 * misfit_s(launches, replays) if launches else None,
            "captures": sum(n.startswith(CAPTURE_CALLS) for n, _, _ in host),
            "base_ns": bspans.base_ns(), "trace_base_ns": trace_base}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    stretches, bases = [], []
    traced, read = run.traced, btrace.read_chrome_trace

    def keep_traced(*a, **k):
        out = traced(*a, **k)
        stretches.append(out)
        return out

    def keep_base(path):
        with open(path) as f:
            bases.append(json.load(f).get("baseTimeNanoseconds"))
        return read(path)

    run.traced, btrace.read_chrome_trace = keep_traced, keep_base
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or not stretches:
        return rc or 1
    line = {"workload": args.workload, "seed": args.seed,
            **report(stretches[0], bases[0] if bases else None)}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
