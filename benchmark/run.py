"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``dmnerf_tpu_torch``) on a machine with
the cards the cell asks for. It sets up (the cell's kernels built into ``build/kernels/``,
the scene and weights made from the seed, every shape of the traffic warmed), measures
for ``--seconds``, checks what the timed path produced against the plain reference, and
prints one JSON line last on stdout: ``correct``, ``attempted``, ``failed``, ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics), ``device`` (with ``busy_s`` and ``window_s`` when traced), ``breakdown`` when
traced, and ``checks`` last: each number compared beside its limit. The numbers compared
are also the last lines on stderr.

The window runs units of the cell's traffic back to back (a closed loop) until
``--seconds`` have passed; the unit running then finishes and counts, and the window ends
with it. With ``--trace 1`` the window's first units (the mix's ``traced_units``) run under
``torch.profiler`` recording the device's activities and the CUDA runtime's calls, whose
Chrome trace the per-layer readers read; one more unit runs with the host's operations
recorded too, and names the idle gaps of the ``breakdown``.

It exits 2 without a result where there is no CUDA card or fewer than the cell asks for,
and 3 where ``jax``, ``jaxlib``, ``flax`` or ``dmnerf_tpu`` is loaded once the window has
closed. ``BENCH_RUN`` in the environment is not read.
"""

import time

T_START = time.time()      # the process's start, for setup_s: before any import below

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dmnerf_tpu")
HOST_THREADS = 2        # PyTorch's host threads: one process with few threads is steadier


@dataclasses.dataclass
class Window:
    kind: str
    setup_s: float
    window_s: float
    units: list

    @property
    def rays(self) -> int:
        return sum(u.rays for u in self.units)

    @property
    def unit_s(self) -> List[float]:
        return [u.seconds for u in self.units]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def traced(driver, n: int, device, host_ops: bool):
    """Run ``n`` units under torch.profiler: (units, device spans, host spans, (t0, t1)).

    On the card the profiler records the device's activities and the CUDA runtime's calls
    (CUPTI), and with ``host_ops`` the host's operations too. Recording those slows a
    host-bound loop (a view's ≈ 8,900 launches) about twice, so the per-layer metrics are
    read from a stretch without them. The window is the annotation around the units where
    the host's operations are recorded, else the first synchronize call to the end of the
    last (``trace.read_chrome_trace``)."""
    import torch

    from benchmark.drivers import sync
    from benchmark.trace import WINDOW, clip, read_chrome_trace

    acts = [torch.profiler.ProfilerActivity.CPU] if host_ops or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    units = []
    with torch.profiler.profile(activities=acts) as prof:
        sync(device)
        with torch.profiler.record_function(WINDOW):
            for _ in range(n):
                units.append(driver.unit())
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        device_spans, host_spans, window = read_chrome_trace(path)
    finally:
        os.remove(path)
    if window is None:
        raise RuntimeError("the profiler's trace has neither the window's annotation nor "
                           "synchronize calls")
    return units, clip(device_spans, *window), clip(host_spans, *window), window


@dataclasses.dataclass
class Traced:
    units: list             # the units of the metrics' stretch
    device: list            # its device activities
    host: list              # its CUDA runtime calls (and host operations off the card)
    window: tuple           # its (start, end)
    named: tuple            # the one unit traced with the host's operations: (units,
                            # device, host, window), whose idle gaps the breakdown names


def measure(driver, seconds: float, trace_units: int, device):
    """(units, window seconds, ``Traced`` or None): units back to back until ``seconds``
    have passed; with ``trace_units``, the first ``trace_units`` of them traced for the
    metrics and one more traced with the host's operations for the breakdown. The set-up's
    objects are moved out of the collector's reach first (``gc.freeze``), so a collection
    inside the window scans only what the window made."""
    gc.collect()
    gc.freeze()
    units, parts = [], None
    start = time.perf_counter()
    if trace_units:
        parts = Traced(*traced(driver, trace_units, device, host_ops=False),
                       named=traced(driver, 1, device, host_ops=True))
        units += parts.units + parts.named[0]
    while not units or time.perf_counter() - start < seconds:
        units.append(driver.unit())
    return units, time.perf_counter() - start, parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import registry
    from benchmark.drivers import stage

    torch.set_num_threads(HOST_THREADS)
    c = registry.cell(args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    stage("python and torch")
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    stage("CUDA context", device)
    result = run_cell(c, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] loaded after the window: {', '.join(bad)}")
        return 3
    for name, v in result["checks"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def log_stages() -> None:
    """Log the set-up's stages (``drivers.stage``) and forget them."""
    from benchmark.drivers import STAGES

    at, parts = T_START, []
    for name, t in STAGES:
        parts.append(f"{name} {t - at:.3f}")
        at = t
    STAGES.clear()
    log("[bench] setup s by stage: " + "; ".join(parts))


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, measure, check: the result line's object (without printing it)."""
    import torch

    from benchmark import registry
    from benchmark.trace import Trace, idle_gaps, top_device_ops

    conf, mix = c["conf"], c["mix"]
    driver = registry.driver(mix["kind"])(conf, mix, seed, device)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - T_START
    units, window_s, parts = measure(driver, seconds, mix["traced_units"] if trace else 0,
                                     device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    driver.verify(units)
    w = Window(driver.kind, setup_s, window_s, units)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    metrics = {}
    if trace:
        def trace_of(n_units, dev_spans, host_spans, window):
            return Trace(conf=conf, kind=kind, work=driver.work(n_units), roles=registry.roles(),
                         device=dev_spans, host=host_spans, t0=window[0], t1=window[1])

        t = trace_of(len(parts.units), parts.device, parts.host, parts.window)
        named = trace_of(len(parts.named[0]), *parts.named[1:])
        for m in c["per_layer"]:
            v = registry.reader("metrics", m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c["end_to_end"]:
            v = registry.reader("e2e", m["name"])(w)
            if v is None:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    driver.release()
    numbers = driver.check()
    limits = c["limits"]
    checks = {}
    for name in registry.limit_names(limits):
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limits[name]}
    correct = bool(checks) and all(math.isfinite(x["value"]) and x["value"] <= x["limit"]
                                   for x in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
                   "count": c["workload"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": sum(u.attempted for u in units),
              "failed": sum(u.attempted for u in units if not u.finite),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": top_device_ops(t), "idle_gaps": idle_gaps(named)}
    log(f"[bench] {c['workload']['name']} seed {seed}: {len(units)} units in {window_s:.3f} s, "
        f"setup {setup_s:.3f} s, peak {peak} B, card {power_limit() if device.type == 'cuda' else 'none'}")
    log_stages()
    if trace:
        rest = units[len(parts.units) + 1:]
        log("[bench] unit ms: traced for the metrics, median "
            f"{1e3 * statistics.median(u.seconds for u in parts.units):.2f}; traced with the "
            f"host's operations {1e3 * parts.named[0][0].seconds:.2f}; untraced, median "
            + (f"{1e3 * statistics.median(u.seconds for u in rest):.2f}" if rest else "none"))
    log(f"[bench] numbers {json.dumps(numbers)}")
    thirds = [units[i * len(units) // 3:(i + 1) * len(units) // 3] for i in range(3)]
    log("[bench] unit ms by third of the window: " + "; ".join(
        f"{len(part)} units, median {1e3 * statistics.median(u.seconds for u in part):.2f}"
        for part in thirds if part))
    result["checks"] = checks
    return result


if __name__ == "__main__":
    raise SystemExit(main())
