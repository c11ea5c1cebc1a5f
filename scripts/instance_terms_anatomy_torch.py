"""What a training step spends on the instance channels raw[..., 4:] on one CUDA card:
the instance map's weighted sum and the emptiness penalizer, forward and backward,
timed as the plain PyTorch passes and as K12, the kernel pair of
dmnerf_tpu_torch/kernels/instance_terms.py, at the train cells' bundles.

    python3 scripts/instance_terms_anatomy_torch.py [--repo DIR] [--steps] [--out FILE]

``--repo`` is the root of the checkout whose ``dmnerf_tpu_torch`` is measured (default:
this one); the measuring code and the bundles' inputs are this checkout's
``chip_smoke.py`` (``k12_inputs``, ``k12_loss``, ``k12_bytes``). A checkout without
``kernels/instance_terms.py`` is measured on the plain passes alone.

Bundles: 3072 rays of 64 (coarse) and 192 (fine) samples, C' = 33 (DM-SR's ins_num 32
and air) and 17 (ScanNet's 16), the penalizer on (tolerance = deta_w = 0.05), logits
of scale 4 with one entry in ten at +-30 (every clamp of the penalizer active). Per
bundle:

  plain_ms       the plain passes forward and backward: composite's instance map
                 (sigmoid of the detached-weight sum, air dropped) and
                 emptiness_penalizer, their gradient of raw by autograd (device busy
                 ms under torch.profiler, the median of 5 calls: the passes are many
                 small launches, so back-to-back timing would time the host);
  kernel_ms      the same through ``instance_terms`` (one K12 forward and one backward
                 launch) and the caller's [N, C'] and scalar work;
  fwd_ms, bwd_ms the two launches alone (``chip_smoke.device_ms``: back-to-back
                 launches with the card held busy while they are enqueued);
  bound_ms       K12's bytes over 3.35 TB/s: raw's instance columns, the weights and
                 z read by each launch, the logits written, g read, d_raw written
                 whole once;
  plain_kernels, kernels  the device activities of one call of each, by name;
  max_err        the kernel's logits, sums and gradient against the plain passes'.

With ``--steps`` also one flagship train step (the
kernel query, 3072 rays, ins_num 32 and 16) under torch.profiler with the penalizer on
and off: device busy ms a step and its top activities that are not the point query's
kernels. The last line of stdout is one JSON object with all of it, with the card's
name and power limit, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAYS = 3072
BUNDLES = [(64, 33), (192, 33), (64, 17), (192, 17)]     # (samples, C')
TOL = DETA_W = 0.05
HBM_BYTES_PER_S = 3.35e12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain_grad(torch, raw, w, z, depth, d, g_ins):
    """The plain passes the step ran before K12: the value and raw's gradient."""
    from dmnerf_tpu_torch.objfield.penalizer import emptiness_penalizer

    raw = raw.detach().requires_grad_(True)
    ins = torch.sigmoid(torch.sum(w[..., None] * raw[..., 4:], dim=-2))[..., :-1]
    loss = (ins * g_ins).sum() + emptiness_penalizer(raw, z, depth, d, TOL, DETA_W)
    return loss.detach(), torch.autograd.grad(loss, raw)[0]


def kernel_grad(torch, cs, it, raw, w, z, depth, d, g_ins):
    """The same through K12 and the caller's [N, C'] and smaller work."""
    raw = raw.detach().requires_grad_(True)
    loss = cs.k12_loss(it.instance_terms, raw, w, z, depth, d, g_ins)[0]
    return loss.detach(), torch.autograd.grad(loss, raw)[0]


def busy(cs, fn, runs: int = 5):
    """``fn``'s device busy ms (the union of its device activity under torch.profiler,
    the median of ``runs`` calls after a warm-up) and its activities of the last call:
    (name, ms, count), longest first."""
    fn()
    profs = [cs.profile_calls(fn) for _ in range(runs)]
    names = sorted(([k, sum(us) / 1e3, len(us)] for k, us in profs[-1]["durations_us"].items()),
                   key=lambda r: -r[1])
    return statistics.median(p["device_busy_ms"] for p in profs), names


def bundle_part(torch, cs, it, device) -> list:
    rows = []
    for S, C in BUNDLES:
        args = cs.k12_inputs(RAYS, S, C, device)
        row = dict(rays=RAYS, samples=S, channels=C,
                   bound_ms=sum(cs.k12_bytes(RAYS, S, C)) / HBM_BYTES_PER_S * 1e3)
        row["plain_ms"], row["plain_kernels"] = busy(cs, lambda: plain_grad(torch, *args))
        if it is not None:
            row["kernel_ms"], row["kernels"] = busy(cs, lambda: kernel_grad(torch, cs, it, *args))
            raw, w, z, depth, d, _ = args
            norm = torch.linalg.norm(d, dim=-1)
            logits, sums = it.instance_terms_fwd(raw, w, z, depth, norm, TOL, DETA_W, True)
            g = torch.randn_like(logits)
            gs = torch.rand_like(sums) * torch.tensor([1.0, 0.0, 1.0, 0.0], device=device)
            row["fwd_ms"] = cs.device_ms(lambda: it.instance_terms_fwd(
                raw, w, z, depth, norm, TOL, DETA_W, True))["device_ms"]
            row["bwd_ms"] = cs.device_ms(lambda: it.instance_terms_bwd(
                raw, w, z, depth, norm, g, gs, TOL, DETA_W, True))["device_ms"]
            (vp, gp), (vk, gk) = plain_grad(torch, *args), kernel_grad(torch, cs, it, *args)
            ref = it.instance_terms_ref(raw, w, z, depth, d, TOL, DETA_W, True)
            row["max_err"] = dict(
                value=float((vk - vp).abs()),
                logits=float((logits - ref[0]).abs().max()),
                sums=[float(x) for x in (sums - ref[1]).abs().max(0).values],
                grad=float((gk - gp).abs().max()), grad_scale=float(gp.abs().max()))
        print(f"[bundle] {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def steps_part(torch, cs, device) -> list:
    """One flagship train step under torch.profiler, the penalizer on and off."""
    from dmnerf_tpu_torch.tools import profile_step as ps

    rows = []
    for ins in (32, 16):
        for pen in (True, False):
            cfg = ps._config(RAYS, ins, perturb=1.0, penalize=pen, tolerance=TOL, deta_w=DETA_W)
            state = ps.create_train_state(cfg, *ps.init_params(cfg, device))
            step = ps.make_train_step(cfg)
            batch = ps._batch(RAYS, ins, device)
            gen = torch.Generator(device=device).manual_seed(2)
            for _ in range(2):
                step(state, batch, generator=gen)
            t = ps.op_table(lambda: step(state, batch, generator=gen), device, top=40)
            glue = [r for r in t["top_device"] if not r["port_kernel"]]
            row = dict(ins_num=ins, penalize=pen, device_busy_ms=t["device_busy_ms"],
                       port_kernel_ms=t["port_kernel_ms"],
                       glue_ms=t["device_ms"] - t["port_kernel_ms"],
                       top_glue=[[r["name"], r["ms"], r["calls"]] for r in glue[:20]])
            print(f"[step] {json.dumps(row)}", flush=True)
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--steps", action="store_true", help="also profile one train step")
    ap.add_argument("--out", default="")
    a_ = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("instance_terms_anatomy_torch: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.abspath(a_.repo)
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    it = None
    if os.path.exists(os.path.join(repo, "dmnerf_tpu_torch", "kernels", "instance_terms.py")):
        from dmnerf_tpu_torch.kernels import instance_terms as it
    device = torch.device("cuda")
    res = dict(device=torch.cuda.get_device_name(0), power_limit_w=subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), torch=torch.__version__,
        kernel=it is not None, bundles=bundle_part(torch, cs, it, device))
    if a_.steps:
        res["steps"] = steps_part(torch, cs, device)
    line = json.dumps(res)
    if a_.out:
        os.makedirs(os.path.dirname(os.path.abspath(a_.out)), exist_ok=True)
        with open(a_.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
