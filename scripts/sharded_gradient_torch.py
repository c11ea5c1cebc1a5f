"""The gradient of one flagship train step sharded over a gloo world of two processes
on one card, against the same step on one device, and how far the same step on one
device with the batch's rays shuffled (the same sums in another order) lies from it:
with the kernel query (K1 / K2) and with the fp32 plain PyTorch query.

    python3 scripts/sharded_gradient_torch.py [--out FILE]

Needs a CUDA card of capability 9.0. Each gradient is read as Adam's first moment after
the step (0.1 x the gradient, in every run alike), from train()'s seeded state and
generators at configs/train/dmsr/study.txt on chip_smoke.py's synthetic scene. Prints,
for each query and each of "sharded" and "shuffled", the six parameters whose
max |d| / max |gradient| against the one-device step is largest, then one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_LIMIT_S = 300


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def first_gradient(cs, plain: bool, mesh=None, shuffle: bool = False) -> dict:
    """0.1 x the gradient of the first step, by parameter, on the host."""
    import torch

    from dmnerf_tpu_torch.parallel.mesh import make_sharded_train_step
    from dmnerf_tpu_torch.render.packing import StepRunner
    from dmnerf_tpu_torch.render.trainstep import create_train_state, make_train_step
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.train import make_sampler

    dev = torch.device("cuda", 0)
    cfg, scene = cs.train_setup(None, "dmsr", N_iters=1, i_print=1, use_pallas=not plain)
    sampler, n_ins = make_sampler(cfg, scene, dev)
    step = (make_train_step(cfg, N_ins=n_ins) if mesh is None
            else make_sharded_train_step(cfg, mesh, N_ins=n_ins))
    if shuffle:
        perm = torch.randperm(cfg.N_train, generator=torch.Generator().manual_seed(0)).to(dev)
        one_step = step

        def step(state, batch, u_z=None, u_pdf=None, **kw):
            return one_step(state, type(batch)(*(None if x is None else x[perm] for x in batch)),
                            u_z=u_z[perm], u_pdf=u_pdf[perm], **kw)
    state = create_train_state(cfg, *init_params(cfg, dev))
    StepRunner(cfg, sampler, step, dev, 1)(state, torch.Generator().manual_seed(cfg.seed + 1),
                                           torch.Generator(device=dev).manual_seed(cfg.seed + 2))
    return {f"{w}.{k}": state.opt.state[p]["exp_avg"].to("cpu", copy=True)
            for w, ps in (("coarse", state.params_coarse), ("fine", state.params_fine))
            for k, p in ps.items()}


def worst(got: dict, want: dict, n: int = 6) -> list:
    rows = [(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30), k)
            for k in want]
    return sorted(rows, reverse=True)[:n]


def rank_main(rank: int, port: int, out_dir: str, plain: bool) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from dmnerf_tpu_torch.parallel.mesh import init_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_process_group(torch.device("cuda", 0), f"tcp://127.0.0.1:{port}", rank=rank,
                              world_size=2, backend="gloo",
                              timeout=datetime.timedelta(seconds=RANK_LIMIT_S))
    try:
        torch.save(first_gradient(_chip_smoke(), plain, mesh),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sharded_gradient_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dmnerf_tpu_torch.kernels import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    runtime.build()
    result = {"card": cs.smi("name,power.limit")}
    for plain in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            port = cs._free_port()
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                       str(port), tmp, "1" if plain else "0"]) for r in range(2)]
            try:
                ref = first_gradient(cs, plain)
                shuffled = first_gradient(cs, plain, shuffle=True)
                for p in procs:
                    p.wait(timeout=RANK_LIMIT_S)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(p.returncode for p in procs):
                raise RuntimeError(f"a rank failed: {[p.returncode for p in procs]}")
            sharded = torch.load(os.path.join(tmp, "rank0.pt"))
        query = "plain" if plain else "kernel"
        result[query] = {"sharded": worst(sharded, ref), "shuffled": worst(shuffled, ref)}
        for name, rows in result[query].items():
            print(f"[{query} {name}] {json.dumps(rows)}", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5] == "1")
        sys.exit(0)
    sys.exit(main())
