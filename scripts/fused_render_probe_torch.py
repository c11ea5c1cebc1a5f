"""The fused render probe on the port: one 256² test view of a synthetic DM-SR scene
rendered through the image renderer (K1 queries, PyTorch compositing) and through the
fused renderer (K8c and K8f: query and compositing in one launch a pass), in one
process, with the same seeded flagship weights. The question of
scripts/dev/fused_render_probe.py (``main``), asked of dmnerf_tpu_torch.

    python3 scripts/fused_render_probe_torch.py [--device cpu] [--size 256] [--reps 5]
                                                [--out FILE]

Model and scene: configs/test/dmsr/study.txt (D=8, W=256, skips (4,), multires 10/4,
N_test 2048, N_samples 64, N_importance 128) with ins_num 32, near 1, far 8, seeded
random weights (``test.init_params``), the first test view of ``build_dmsr_scene``
(4 objects, seed 0). Printed:

  * ms a view of each renderer: the median of ``--reps`` synchronised calls on the
    host clock, the two renderers in turns (K1, fused, fused, K1, ...);
  * max|Δ| of rgb, depth and the instance maps between them, the rgb PSNR and the share
    of pixels whose argmax label differs;
  * the launches of each kernel in one view of each;
  * on the card, one view of each under torch.profiler (``tools.profile_step.op_table``):
    device activities a chunk, the device's busy ms and idle share, the port's kernels'
    device ms, and the fused kernels' device ms a chunk beside what they replace in the
    K1 view (K1's device ms and every other op of that view but the glue both views
    keep, which is the fused view's non-kernel device time).

Without a card (``--device cpu``) the renderers run their plain versions and only host
times are printed; the device columns read "not measured". The last line of stdout is
one JSON object with all of it, also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scene_view(device, size: int = 256):
    """(cfg, params_coarse, params_fine, rays_o, rays_d) of the probe's view."""
    import torch

    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.core.rays import rays_from_K
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene
    from dmnerf_tpu_torch.test import init_params

    cfg = load_config(os.path.join(REPO, "configs", "test", "dmsr", "study.txt"), ins_num=32,
                      near=1.0, far=8.0, perturb=0.0)
    scene = build_dmsr_scene(n_train=1, n_test=1, H=size, W=size, n_objects=4, ins_num=32,
                             seed=0)
    pc, pf = init_params(cfg, device)
    K = torch.as_tensor(scene.K, device=device)
    c2w = torch.as_tensor(scene.poses[scene.i_test[0]], device=device)
    rays_o, rays_d = rays_from_K(size, size, K, c2w)
    return cfg, pc, pf, rays_o.reshape(-1, 3).contiguous(), rays_d.reshape(-1, 3).contiguous()


def compare_views(device, size: int = 256, reps: int = 5) -> dict:
    """The probe's numbers (module docstring) as a dict; ``k1`` and ``fused`` hold each
    renderer's outputs of the view under ``maps``."""
    import numpy as np
    import torch

    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.fused_renderer import make_fused_renderer
    from dmnerf_tpu_torch.render.renderer import make_image_renderer

    cfg, pc, pf, rays_o, rays_d = scene_view(device, size)
    renderers = {"k1": make_image_renderer(cfg), "fused": make_fused_renderer(cfg)}
    res = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "size": size, "chunks": -(-size * size // cfg.N_test)}
    for name, render in renderers.items():
        runtime.reset_launches()
        maps = render(pc, pf, rays_o, rays_d)
        _sync(device)
        res[name] = {"maps": maps, "launches": {k: v for k, v in runtime.LAUNCHES.items() if v}}
    times = {name: [] for name in renderers}
    for name in [n for i in range(reps) for n in (("k1", "fused"), ("fused", "k1"))[i % 2]]:
        _sync(device)
        t0 = time.perf_counter()
        renderers[name](pc, pf, rays_o, rays_d)
        _sync(device)
        times[name].append((time.perf_counter() - t0) * 1e3)
    for name in renderers:
        res[name]["ms_per_view_runs"] = times[name]
        res[name]["ms_per_view"] = statistics.median(times[name])
    a, b = res["k1"]["maps"], res["fused"]["maps"]
    mse = float(torch.mean((a["rgb"].double() - b["rgb"].double()) ** 2))
    res["fused_vs_k1"] = {
        **{f"{k}_max_abs_diff": float((a[k] - b[k]).abs().max()) for k in ("rgb", "depth", "ins")},
        "rgb_psnr_db": float("inf") if mse == 0 else float(-10.0 * np.log10(mse)),
        "label_flip_share": float((a["ins"].argmax(-1) != b["ins"].argmax(-1)).float().mean())}
    if device.type == "cuda":
        from dmnerf_tpu_torch.tools.profile_step import op_table

        for name, render in renderers.items():
            t = op_table(lambda: render(pc, pf, rays_o, rays_d), device, top=8)
            res[name]["profile"] = {
                "activities_per_chunk": t["device_launches"] / res["chunks"],
                "device_busy_ms": t["device_busy_ms"], "device_idle_share": t["device_idle_share"],
                "device_ms": t["device_ms"], "port_kernel_ms": t["port_kernel_ms"],
                "wall_ms": t["wall_ms"], "top_device": t["top_device"]}
        k1p, fp = res["k1"]["profile"], res["fused"]["profile"]
        kept = fp["device_ms"] - fp["port_kernel_ms"]          # the glue both views keep
        res["fused_kernels_vs_replaced"] = {
            "fused_kernel_ms_per_chunk": fp["port_kernel_ms"] / res["chunks"],
            "k1_ms_per_chunk": k1p["port_kernel_ms"] / res["chunks"],
            "replaced_ms_per_chunk": (k1p["device_ms"] - kept) / res["chunks"]}
    else:
        res["profile"] = "not measured (no card)"
    return res


def _printable(res: dict) -> dict:
    return {k: ({kk: vv for kk, vv in v.items() if kk != "maps"} if isinstance(v, dict) else v)
            for k, v in res.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--size", type=int, default=256, help="the view's height and width")
    ap.add_argument("--reps", type=int, default=5, help="timed views of each renderer")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    args = ap.parse_args(argv)
    import torch

    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        runtime.build()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    res = _printable(compare_views(device, args.size, args.reps))
    res["card"] = card
    for name in ("k1", "fused"):
        r = res[name]
        print(f"[probe] {name}: {r['ms_per_view']:.2f} ms a view ({res['device']}, host clock; "
              f"runs {[round(t, 2) for t in r['ms_per_view_runs']]}), launches {r['launches']}",
              flush=True)
        if "profile" in r:
            p = r["profile"]
            print(f"[probe] {name}: {p['activities_per_chunk']:.1f} device activities a chunk, "
                  f"busy {p['device_busy_ms']:.2f} ms, idle share {p['device_idle_share']:.3f}, "
                  f"port kernels {p['port_kernel_ms']:.2f} ms of {p['device_ms']:.2f}", flush=True)
    print(f"[probe] fused vs k1: {json.dumps(res['fused_vs_k1'])}", flush=True)
    if "fused_kernels_vs_replaced" in res:
        print(f"[probe] fused kernels vs what they replace: "
              f"{json.dumps(res['fused_kernels_vs_replaced'])}", flush=True)
    print(card, flush=True)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
