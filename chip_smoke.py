"""Drive the PyTorch/H100 port (dmnerf_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

0. Requires a CUDA card of capability 9.0 and prints its name and power limit.
   TF32 is off, so the fp32 plain path is really fp32.
1. Builds every kernel of the render path from dmnerf_tpu_torch/kernels/csrc with
   nvcc (sm_90a), one process per source, and prints the build time and the
   compiler's register report.
2. Kernel phase, at the flagship model's width (configs/test/dmsr/study.txt:
   D=8, W=256, skips (4,), multires 10/4, ins_num 32) with seeded random weights
   and points along rays between near and far: the fused PE+MLP kernel on a fine
   chunk (2048 x 192 points, full model) and a coarse chunk (2048 x 64, sigma
   stub), held against its plain version in fp32 (max|d| <= 5e-3 * max(scale, 1))
   and in bf16 (printed); the stub's sigma column against the full model's, both
   from the kernel (within 1e-5 * max(sigma scale, 1)). Median times of the
   kernel, the fp32 plain version and a bf16 torch.matmul chain over the same
   packed layers (the library yardstick, used nowhere in the port), beside the
   bound: executed matrix FLOPs over the card's 989 TFLOP/s bf16 peak, or bytes
   over 3.35 TB/s, whichever is larger.
3. Slice phase: a synthetic DM-SR scene built in memory (256x256, 2 test views,
   4 objects, ins_num 32, near 1, far 8) rendered by the port's render_test with
   seeded full-width weights. Every map must be finite and in range, the kernel's
   launch count must be 2 x chunks x views, and one view rendered with the plain
   PyTorch query on the card must agree with the kernel's render (rgb PSNR >= 40 dB,
   at most 1% of pixels with another argmax instance label).

The line before the last is a JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
KERNEL_TOL = 5e-3            # kernel vs fp32 plain: max|d| <= 5e-3 * max(scale, 1)
STUB_TOL = 1e-5              # stub sigma vs full sigma: <= 1e-5 * max(sigma scale, 1)
MIN_PSNR_DB = 40.0           # kernel render vs plain render, rgb
MAX_LABEL_FLIP = 0.01        # share of pixels whose argmax instance label differs
SEED = 0


def _time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def query_macs(params) -> int:
    """Multiply-accumulates per point of the fused query's own products (no padding):
    trunk, M1 = [Wrf.Wrh1 | Wif.Wih | Wd], the viewdir contraction and the two outputs."""
    D = sum(1 for k in params if k.startswith("trunk_") and k.endswith("_w"))
    macs = sum(params[f"trunk_{i}_w"].numel() for i in range(D))
    W = params["density_w"].shape[0]
    Hr, Hi = params["rgb_hid_w"].shape[1], params["ins_hid_w"].shape[1]
    Ed = params["rgb_hid_w"].shape[0] - params["rgb_feat_w"].shape[1]
    C = params["ins_out_w"].shape[1]
    return macs + W * (Hr + Hi + 1) + Ed * Hr + Hr * 3 + Hi * C


def library_query(packed, pts, viewdirs):
    """The same function as one bf16 torch.addmm per packed layer (cuBLAS), for
    library_ms only."""
    import torch

    from dmnerf_tpu_torch.kernels.fused_mlp import _embedding, view_embedding

    N, S, _ = pts.shape
    bf = torch.bfloat16
    e = _embedding(pts.reshape(N * S, 3), packed.multires, packed.ep).to(bf)
    ed = view_embedding(packed, viewdirs).to(bf).repeat_interleave(S, dim=0)
    b_all = packed.b.to(bf)
    h = sigma = None
    for layer in packed.layers:
        w = packed.w_bf16[layer.w_off:layer.w_off + layer.K * layer.N].view(layer.K, layer.N)
        b = b_all[layer.b_off:layer.b_off + layer.N]
        a = {"emb0": e, "plain": h, "sigma": h, "out": h}.get(layer.kind)
        if layer.kind == "split":
            a = torch.cat([h, e], dim=-1)
        elif layer.kind == "head":
            a = torch.cat([ed, h], dim=-1)
        y = torch.addmm(b, a, w)
        if layer.kind == "sigma":
            sigma = y[:, :1]
        elif layer.kind == "out":
            y[:, 3:4] = sigma
            return y[:, :packed.c4].float().reshape(N, S, packed.c4)
        else:
            h = torch.relu(y)
    raise ValueError("packed layer table has no output layer")


def _points(n_rays, n_samples, near, far, gen, device):
    """Rays from a camera at radius 4 looking at the origin; samples between near
    and far, sorted (fine-pass-like when random, coarse-like when linspace)."""
    import torch

    o = torch.tensor([4.0, 0.0, 1.6]).expand(n_rays, 3)
    d = -o + torch.randn((n_rays, 3), generator=gen) * 0.5
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.sort(near + (far - near) * torch.rand((n_rays, n_samples), generator=gen)).values
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    return pts.contiguous().to(device), d.contiguous().to(device)


def kernel_phase(cfg, device):
    import torch

    from dmnerf_tpu_torch.core.mlp import sigma_stub_params
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.kernels.fused_mlp import fused_query, fused_query_ref, pack_params
    from dmnerf_tpu_torch.test import init_params

    pc, pf = init_params(cfg, device)
    gen = torch.Generator().manual_seed(SEED + 1)
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    N = cfg.N_test
    fine_pts, fine_dirs = _points(N, cfg.N_samples + cfg.N_importance, cfg.near, cfg.far, gen, device)
    coarse_pts, coarse_dirs = _points(N, cfg.N_samples, cfg.near, cfg.far, gen, device)
    cases = [
        ("fine", pf, pack_params(pf, *args), fine_pts, fine_dirs),
        ("coarse_stub", sigma_stub_params(pc), pack_params(sigma_stub_params(pc), *args),
         coarse_pts, coarse_dirs),
    ]
    results = {}
    with torch.no_grad():
        for name, params, packed, pts, dirs in cases:
            got = fused_query(packed, pts, dirs)
            torch.cuda.synchronize()
            ref32 = fused_query_ref(packed, pts, dirs, torch.float32)
            ref16 = fused_query_ref(packed, pts, dirs, torch.bfloat16)
            lib = library_query(packed, pts, dirs)
            scale = float(ref32.abs().max())
            err32 = float((got - ref32).abs().max())
            err16 = float((got - ref16).abs().max())
            errlib = float((lib - ref32).abs().max())
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: kernel output is not finite")
            if got.shape != ref32.shape:
                raise AssertionError(f"{name}: kernel shape {tuple(got.shape)} vs {tuple(ref32.shape)}")
            P = pts.shape[0] * pts.shape[1]
            flops = 2.0 * query_macs(params) * P
            nbytes = (pts.numel() * 4 + dirs.numel() * 4 + packed.w_bf16.numel() * 2
                      + packed.b.numel() * 4 + got.numel() * 4)
            ms = _time_ms(lambda: fused_query(packed, pts, dirs))
            plain_ms = _time_ms(lambda: fused_query_ref(packed, pts, dirs, torch.float32), reps=5)
            library_ms = _time_ms(lambda: library_query(packed, pts, dirs))
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            r = dict(points=P, out_scale=scale, max_abs_err=err32, max_abs_err_bf16_plain=err16,
                     library_max_abs_err=errlib, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                     gflop=flops / 1e9, mbytes=nbytes / 1e6, tflops=flops / (ms * 1e-3) / 1e12)
            print(f"[kernel] {name}: {json.dumps(r)}", flush=True)
            if err32 > KERNEL_TOL * max(scale, 1.0):
                raise AssertionError(f"{name}: kernel vs fp32 plain max|d| {err32:.3e} > "
                                     f"{KERNEL_TOL} * max({scale:.3e}, 1)")
            results[name] = r

        # the sigma stub's sigma column vs the full coarse model's, both through the kernel
        full = fused_query(pack_params(pc, *args), coarse_pts, coarse_dirs)[..., 3]
        stub = fused_query(cases[1][2], coarse_pts, coarse_dirs)[..., 3]
        sig_scale = float(full.abs().max())
        stub_err = float((stub - full).abs().max())
        print(f"[kernel] stub sigma vs full sigma: max|d| {stub_err:.3e} at sigma scale "
              f"{sig_scale:.3e}", flush=True)
        if stub_err > STUB_TOL * max(sig_scale, 1.0):
            raise AssertionError(f"stub sigma max|d| {stub_err:.3e} > {STUB_TOL} * max({sig_scale:.3e}, 1)")
    runtime.reset_launches()
    return results


def slice_phase(cfg, device):
    import numpy as np
    import torch

    from dmnerf_tpu_torch.core.pipeline import make_torch_query_fn
    from dmnerf_tpu_torch.core.rays import rays_from_K
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene
    from dmnerf_tpu_torch.kernels import runtime
    from dmnerf_tpu_torch.render.evaluation import render_test
    from dmnerf_tpu_torch.render.renderer import make_image_renderer
    from dmnerf_tpu_torch.test import init_params

    H = W = 256
    n_views = 2
    scene = build_dmsr_scene(n_train=1, n_test=n_views, H=H, W=W, n_objects=4, ins_num=32,
                             seed=SEED)
    cfg = cfg.replace(near=1.0, far=8.0, ins_num=scene.ins_num, perturb=0.0)
    pc, pf = init_params(cfg, device)
    ids = scene.i_test

    runtime.reset_launches()
    res = render_test(cfg, pc, pf, scene.poses[ids], scene.hwk, gt_imgs=scene.images[ids],
                      gt_labels=scene.gt_labels[ids], ins_rgbs=scene.ins_rgbs, savedir=None,
                      device=device)
    launches = dict(runtime.LAUNCHES)

    chunks = -(-H * W // cfg.N_test)
    want = 2 * chunks * n_views
    if launches["fused_mlp_fwd"] != want:
        raise AssertionError(f"fused_mlp_fwd launched {launches['fused_mlp_fwd']} times, want "
                             f"2 x {chunks} chunks x {n_views} views = {want}")
    for img in res["images"]:
        if img.shape != (H, W, 3) or not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
            raise AssertionError(f"rendered rgb out of range: shape {img.shape}, "
                                 f"[{img.min()}, {img.max()}]")

    # one view through the kernel and through the plain PyTorch query, on the card
    K = torch.as_tensor(scene.K, device=device)
    c2w = torch.as_tensor(scene.poses[ids[0]], device=device)
    rays_o, rays_d = rays_from_K(H, W, K, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    ours = make_image_renderer(cfg)(pc, pf, rays_o, rays_d)
    plain_q = make_torch_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    plain = make_image_renderer(cfg, query_fn=plain_q)(pc, pf, rays_o, rays_d)
    for name, out in (("kernel", ours), ("plain", plain)):
        for k in ("rgb", "ins"):
            v = out[k]
            if not torch.isfinite(v).all() or float(v.min()) < 0 or float(v.max()) > 1:
                raise AssertionError(f"{name} {k} map not finite in [0, 1]")
        d = out["depth"]
        if not torch.isfinite(d).all() or float(d.min()) < 0 or float(d.max()) > cfg.far * 1.0001:
            raise AssertionError(f"{name} depth map not finite in [0, far]")
    mse = float(torch.mean((ours["rgb"].double() - plain["rgb"].double()) ** 2))
    psnr = float("inf") if mse == 0 else float(-10.0 * np.log10(mse))
    flip = float((ours["ins"].argmax(-1) != plain["ins"].argmax(-1)).float().mean())
    depth_err = float((ours["depth"] - plain["depth"]).abs().max())

    ms = [t * 1e3 for t in res["times"]]
    out = dict(views=n_views, H=H, W=W, chunks_per_view=chunks, launches=launches,
               psnr=res["psnrs"], ssim=res["ssims"], ap=[list(a) for a in res["aps"]],
               ms_per_image=ms, rays_per_s=[H * W / (t * 1e-3) for t in ms],
               kernel_vs_plain=dict(rgb_psnr_db=psnr, label_flip_share=flip,
                                    depth_max_abs_err=depth_err))
    print(f"[slice] {json.dumps(out)}", flush=True)
    if psnr < MIN_PSNR_DB or flip > MAX_LABEL_FLIP:
        raise AssertionError(f"kernel render vs plain render: rgb PSNR {psnr:.2f} dB "
                             f"(want >= {MIN_PSNR_DB}), label flips {flip:.4f} "
                             f"(want <= {MAX_LABEL_FLIP})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.kernels import runtime

    if torch.cuda.get_device_capability(0) != (9, 0):
        print(f"chip_smoke: want a capability 9.0 card, got {torch.cuda.get_device_capability(0)}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    reports = runtime.build()
    print(f"[build] {len(reports)} kernel(s) in {time.time() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    device = torch.device("cuda")
    cfg = load_config(os.path.join(REPO, "configs", "test", "dmsr", "study.txt"), ins_num=32)
    kres = kernel_phase(cfg, device)
    launches = slice_phase(cfg, device)

    fine = kres["fine"]
    kernels = [{
        "name": "fused_mlp_fwd", "route": "cuda",
        "source": "dmnerf_tpu_torch/kernels/csrc/fused_mlp_fwd.cu",
        "replaces": "dmnerf_tpu/kernels/fused_mlp.py:507",
        "launches": launches["fused_mlp_fwd"], "max_abs_err": fine["max_abs_err"],
        "ms": fine["ms"], "plain_ms": fine["plain_ms"], "bound_ms": fine["bound_ms"],
        "bound_by": fine["bound_by"], "library_ms": fine["library_ms"],
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
