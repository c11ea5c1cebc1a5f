"""Where the parameter backward of the PyTorch/H100 port spends its time, on one CUDA
card: the question scripts/dev/bwd_anatomy.py asked of the TPU kernel (the
rematerialised forward, the dX chain, the dW products), asked of dmnerf_tpu_torch's
K2, K4 and K6, together with the train steps they sit in.

    python3 scripts/bwd_anatomy_torch.py [--repo DIR] [--tag NAME] [--out FILE]

``--repo`` is the root of the checkout whose ``dmnerf_tpu_torch`` is measured (default:
this one); the measuring code is this checkout's ``chip_smoke.py``. Running it on two
checkouts on one card, in turns (A, B, B, A), compares two versions of the
kernels on one card. For each pe_mode ('kernel_t' K2, 'kernel' K4, 'outside' K6) at
the flagship training shapes (configs/train/dmsr/study.txt: fine 3072 x 192 points,
coarse 3072 x 64, both through the full model, seeded random weights) it prints:

  launch_ms   device ms of each launch kind of one standalone backward call
              (fused_query_bwd and its kin: the forward that writes the stash, the
              backward-data walk, the dW products, the reductions), from torch.profiler;
  entry_ms    CUDA-event median of that standalone call;
  fwd_bwd_ms  the query as training runs it: fused_query with gradients, then
              autograd's backward into Packed.w / Packed.b;
  library_fwd_bwd_ms  the same through one bf16 torch.addmm per packed layer and its
              autograd backward (a yardstick the port never calls);
  peak_gb     peak device memory of fwd_bwd;
  fwd_digest  a hash of the bytes of the no-grad forward's raw output (K1, K3, K5 over
              K7), so two checkouts' forwards can be compared bit for bit.

Then the median host-clock ms of 10 steady flagship DM-SR train steps (default
pe_mode) and 10 ScanNet steps (pallas_pe_mode = outside), each with its peak device
memory. The last line of stdout is one JSON object with all of it, also written to
``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def query_split(cs, device):
    import torch

    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.kernels import fused_mlp as fm
    from dmnerf_tpu_torch.test import init_params

    cfg = load_config(os.path.join(HERE, "configs", "train", "dmsr", "study.txt"), ins_num=32,
                      near=1.0, far=8.0)
    pc, pf = init_params(cfg, device)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    N = cfg.N_train
    shapes = [("fine", pf, *cs._points(N, cfg.N_samples + cfg.N_importance, cfg.near, cfg.far,
                                       gen, device)),
              ("coarse", pc, *cs._points(N, cfg.N_samples, cfg.near, cfg.far, gen, device))]
    out = {}
    for mode in ("kernel_t", "kernel", "outside"):
        for name, params, pts, dirs in shapes:
            packed = fm.pack_params(params, *args)
            w = torch.linspace(0.5, 1.5, packed.c4, device=device)
            with torch.no_grad():
                raw = fm.fused_query(packed, pts, dirs, mode)
            digest = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]
            g = ((1.0 - torch.tanh(raw) ** 2) * w).contiguous()
            if mode == "outside":
                e, ed = cs._kernel_embedded(packed, pts, dirs)
                g_flat = g.reshape(-1, packed.c4)

                def entry():
                    return fm.fused_query_pe_bwd(packed, e, ed, g_flat)
            else:
                def entry():
                    return cs._bwd(mode, packed, pts, dirs, g)
            pk = dataclasses.replace(packed, w=packed.w.detach().requires_grad_(True),
                                     b=packed.b.detach().requires_grad_(True))

            def fwd_bwd():
                return torch.autograd.grad(fm.fused_query(pk, pts, dirs, mode), [pk.w, pk.b], g)
            lib = dataclasses.replace(packed, w_bf16=packed.w_bf16.detach().clone().requires_grad_(True),
                                      b=packed.b.detach().clone().requires_grad_(True))

            def lib_fwd_bwd():
                return torch.autograd.grad(cs.library_query(lib, pts, dirs, mode),
                                           [lib.w_bf16, lib.b], g)
            r = dict(points=pts.shape[0] * pts.shape[1], fwd_digest=digest,
                     launch_ms=cs.launch_split(entry),
                     entry_ms=cs._time_ms(entry, reps=5))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r["fwd_bwd_ms"] = cs._time_ms(fwd_bwd, reps=5)
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["library_fwd_bwd_ms"] = cs._time_ms(lib_fwd_bwd, reps=5)
            print(f"[anatomy] {mode} {name}: {json.dumps(r)}", flush=True)
            out[f"{mode}/{name}"] = r
            del raw, g, pk, lib
            torch.cuda.empty_cache()
    return out


def step_times(cs, device):
    import tempfile

    import torch

    from dmnerf_tpu_torch.test import init_params

    out = {}
    for pe_mode, dataset in ((None, "dmsr"), ("outside", "scannet")):
        with tempfile.TemporaryDirectory() as tmp:
            cfg, scene = cs.train_setup(pe_mode, dataset, basedir=tmp)
            pc, pf = init_params(cfg, device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = cs.steady_step_ms(cfg, scene, pc, pf, device)
            r = dict(step_ms=statistics.median(times), step_ms_range=[min(times), max(times)],
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[anatomy] step {dataset} pe_mode={pe_mode}: {json.dumps(r)}", flush=True)
        out[f"step/{dataset}"] = r
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bwd_anatomy_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    from dmnerf_tpu_torch.kernels import runtime

    t0 = time.time()
    runtime.build()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = dict(tag=a.tag, repo=os.path.abspath(a.repo), device=torch.cuda.get_device_name(0),
               card=smi, build_s=time.time() - t0)
    res.update(query_split(cs, device))
    res.update(step_times(cs, device))
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
