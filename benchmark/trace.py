"""A traced stretch of the window, read from ``torch.profiler``'s Chrome trace: the device's
activities (kernels, copies, fills), the CUDA runtime's calls and, where recorded, the
host's operations, the roles' kernels, and the ``breakdown`` of the result line.

The per-layer readers (``benchmark/metrics/<name>.py``) take a ``Trace`` and return a
number or None; the helpers below are what they share.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
WINDOW = "benchmark.window"     # the annotation around the traced units
SYNC = "cudaDeviceSynchronize"  # the runtime call of torch.cuda.synchronize
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync")
Span = Tuple[str, float, float]     # (name, start s, end s)


@dataclasses.dataclass
class Trace:
    conf: dict                  # the configuration
    kind: str                   # torch.cuda.get_device_name()
    work: dict                  # the driver's count of the traced units (see drivers)
    roles: Dict[str, dict]      # role -> {"kernels": [patterns], "work": {...} or None}
    device: List[Span]          # device activities inside the window
    host: List[Span]            # host operations and runtime calls inside the window
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return yardstick.union_seconds((s, e) for _, s, e in self.device)

    def role_of(self, name: str) -> Optional[str]:
        for role, r in sorted(self.roles.items()):
            if any(p in name for p in r["kernels"]):
                return role
        return None

    def by_role(self) -> Dict[Optional[str], float]:
        """Device seconds by role (None: the activities no role claims)."""
        roles: Dict[str, Optional[str]] = {}
        out: Dict[Optional[str], float] = defaultdict(float)
        for n, s, e in self.device:
            if n not in roles:
                roles[n] = self.role_of(n)
            out[roles[n]] += e - s
        return out

    def role_seconds(self, role: Optional[str]) -> float:
        """Device seconds of the activities of ``role`` (None: those no role claims)."""
        return self.by_role().get(role, 0.0)


def read_chrome_trace(path: str) -> Tuple[List[Span], List[Span], Optional[Tuple[float, float]]]:
    """(device activities, host events, the window), in seconds, from an exported Chrome
    trace. The window is the annotation ``WINDOW`` where the host's operations were
    recorded; else (the device's activities and the runtime's calls alone) it runs from
    the start of the first ``SYNC`` call to the end of the last, the calls that open and
    close the traced units."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "user_annotation" and name == WINDOW:
            window = (s, e)
        elif cat in HOST_CATS:
            host.append((name, s, e))
    syncs = [(s, e) for name, s, e in host if name == SYNC]
    if window is None and syncs:
        window = (min(s for s, _ in syncs), max(e for _, e in syncs))
    return device, host, window


def clip(spans: List[Span], t0: float, t1: float) -> List[Span]:
    return [(n, max(s, t0), min(e, t1)) for n, s, e in spans if e > t0 and s < t1]


def short(name: str, n: int = 96) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its trailing argument
    list, at most ``n`` characters."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].strip() or name
                break
    return name[:n]


def top_device_ops(t: Trace, n: int = 10) -> List[list]:
    by = defaultdict(float)
    for name, s, e in t.device:
        by[short(name)] += e - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(t: Trace, n: int = 10) -> List[list]:
    """The window's idle time on the device, by the innermost host operation open at the
    middle of each gap, the largest first."""
    busy = yardstick.merge((s, e) for _, s, e in t.device)
    gaps, at = [], t.t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t.t1 > at:
        gaps.append((at, t.t1))
    by = defaultdict(float)
    host = sorted((hs, he, name) for name, hs, he in t.host)
    open_: list = []        # (-start, end, -order, name): the latest started on top
    at = 0
    for s, e in gaps:       # in time order, so a host operation that ended stays ended
        mid = 0.5 * (s + e)
        while at < len(host) and host[at][0] <= mid:
            hs, he, name = host[at]
            heapq.heappush(open_, (-hs, he, -at, name))
            at += 1
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        by[open_[0][3] if open_ else "(no host operation)"] += e - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# ---- what the per-layer readers share


def share_of_peak(t: Trace, flops: float) -> Optional[float]:
    peak = yardstick.PEAK_FLOPS.get(t.kind)
    if not peak or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * flops / t.window_s / peak


def roofline(t: Trace, role: str) -> Optional[float]:
    """The role's least time over its kernels' device time, in %; None where none of
    its kernels ran or the card's peaks are unknown."""
    r = t.roles.get(role)
    dev = t.role_seconds(role)
    if r is None or not r.get("work") or dev <= 0 or t.kind not in yardstick.PEAK_FLOPS:
        return None
    least = yardstick.least_seconds(t.conf, t.work["queries"], r["work"]["pass"], t.kind)
    return 100.0 * least / dev if least > 0 else None


def idle_share(t: Trace) -> Optional[float]:
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 and t.device else None


def launches(t: Trace) -> int:
    return sum(1 for name, _, _ in t.host if name.startswith(LAUNCH_CALLS))
