"""The readings that set a cell's limits (``limits/<cell>.json``), in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... [--control 1,2,3]
        [--faults half_batch,...] [--seconds 2] [--out FILE]

For each seed of ``--seeds``: the program's set-up and a short window at the cell's own
sizes, then its numbers against the reference (the lower readings). For each seed of
``--control``: the control's numbers, the reference computed with float8 operands in the
program's place (the upper readings). For each fault of ``--faults`` (``faults.FAULTS``)
and each control seed: the program with the fault planted. Prints one JSON object, and
writes it to ``--out`` when given. Needs a CUDA card, as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from benchmark import registry
from benchmark.drivers import STAGES
from benchmark.faults import planted


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def reading(c: dict, seed: int, seconds: float, device, prec: str = "fp32", fault=None) -> dict:
    driver = registry.driver(c["mix"]["kind"])(c["conf"], c["mix"], seed, device)
    t0 = time.perf_counter()
    with planted(fault) if fault else contextlib.nullcontext():
        driver.setup()
        setup = time.perf_counter() - t0
        units = [driver.unit()]
        while time.perf_counter() - t0 - setup < seconds:
            units.append(driver.unit())
        driver.release()
    t1 = time.perf_counter()
    numbers = driver.check(prec)
    out = {"seed": seed, "prec": prec, "fault": fault, "units": len(units),
           "setup_s": setup, "check_s": time.perf_counter() - t1, **numbers,
           "worst": getattr(driver, "worst", None)}
    del driver
    STAGES.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(out), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    c = registry.cell(args.workload)
    rows = [reading(c, s, args.seconds, device) for s in args.seeds]
    rows += [reading(c, s, 0.0, device, "fp8") for s in args.control]
    for fault in [f for f in args.faults.split(",") if f]:
        rows += [reading(c, s, 0.0, device, fault=fault) for s in args.control]
    res = {"workload": args.workload, "device": torch.cuda.get_device_name(device), "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
