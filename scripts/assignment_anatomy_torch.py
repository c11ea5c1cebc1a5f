"""K11 (the instance loss's assignment) split by its valid row count, with several builds
of ``csrc/assignment.cu`` timed in turns on the card.

    python3 scripts/assignment_anatomy_torch.py [--src NAME=FILE ...] [--n 32]
        [--valid 0,1,2,3,5,8,16,32] [--kinds uniform,ties] [--out FILE]

Each source (by default this checkout's ``dmnerf_tpu_torch/kernels/csrc/assignment.cu``
as ``checkout``; add a parent's or a variant's with ``--src``, for example the parent
commit's from ``git show HEAD~:dmnerf_tpu_torch/kernels/csrc/assignment.cu``) is built
with the port's nvcc flags into ``build/assignment_builds/`` and loaded with ctypes (its
``dmnerf_assignment``, the entry every build has). For seeded [2, n, n] costs (uniform,
and integers 0-2 with ties) and each valid row count, the sources run in turns (first
to last, then last to first): K11's own duration from torch.profiler over 50 launches
(median, ``profiler_us``) and the device time of 50 back-to-back launches
(``chip_smoke.device_ms``, ``device_us``), beside the Dijkstra iterations those costs
need (the plain version's count) and whether each build's col4row is the plain
version's. ``valid`` 0 is a launch that stages the costs and writes the padding rows
alone; the slope over ``valid`` is a row's cost. One line of JSON a (costs, valid); the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build(src: str):
    """``src`` built with the port's nvcc flags, loaded: its ``dmnerf_assignment``."""
    from dmnerf_tpu_torch.kernels import runtime

    code = open(src, "rb").read()
    out_dir = os.path.join(HERE, "build", "assignment_builds")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"assignment-{hashlib.sha256(code).hexdigest()[:16]}.so")
    if not os.path.exists(so):
        subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", so, src], check=True,
                       capture_output=True, text=True)
    fn = ctypes.CDLL(so).dmnerf_assignment
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def costs(kind: str, n: int, seed: int = 0):
    import numpy as np

    rng = np.random.RandomState(seed)
    c = rng.rand(2, n, n) if kind == "uniform" else rng.randint(0, 3, (2, n, n))
    return c.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=FILE: another assignment.cu to time in turns")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--valid", default="0,1,2,3,5,8,16,32")
    ap.add_argument("--kinds", default="uniform,ties")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("assignment_anatomy_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from dmnerf_tpu_torch.kernels.assignment import masked_assignment_ref

    cs = _chip_smoke()
    card = cs.smi("name,power.limit")
    print(f"[card] {card}", flush=True)
    srcs = {"checkout": os.path.join(HERE, "dmnerf_tpu_torch", "kernels", "csrc", "assignment.cu")}
    srcs.update(s.split("=", 1) for s in args.src)
    fns = {name: build(path) for name, path in srcs.items()}
    device = torch.device("cuda")
    n, B = args.n, 2
    lines = []
    for kind in args.kinds.split(","):
        c = costs(kind, n)
        cost = torch.from_numpy(c).to(device)
        for valid in (int(v) for v in args.valid.split(",")):
            iterations = []
            want = masked_assignment_ref(torch.from_numpy(c), valid, iterations)
            valid_t = torch.full((B,), valid, dtype=torch.int32, device=device)
            outs = {name: torch.empty((B, n), dtype=torch.long, device=device) for name in fns}

            def launcher(name):
                def launch():
                    err = fns[name](cost.data_ptr(), valid_t.data_ptr(), outs[name].data_ptr(),
                                    B, n, torch.cuda.current_stream(device).cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                return launch
            res = {name: dict(profiler_us=[], device_us=[]) for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                fn = launcher(name)
                res[name]["device_us"].append(cs.device_ms(fn)["device_ms"] * 1e3)
                prof = cs.kernel_us(fn, "assignment_kernel")
                res[name]["profiler_us"].append(statistics.median(prof) if prof else None)
            torch.cuda.synchronize()
            for name in fns:
                res[name]["col4row_equal"] = bool(torch.equal(outs[name].cpu(), want))
            line = dict(card=card, n=n, costs=kind, valid=valid, dijkstra_iterations=iterations,
                        builds=res)
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    bad = [(line["costs"], line["valid"], name) for line in lines
           for name, r in line["builds"].items() if not r["col4row_equal"]]
    if bad:
        print(f"assignment_anatomy_torch: col4row differs from the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
