"""Per-stage profiler of the train step and the render chunk
(``dmnerf_tpu/tools/profile_step.py``).

  stages    each forward stage of a step alone at the flagship shape (PE, MLP, the
            plain and the kernel query, composite, sample_pdf, the sort of the union)
  backward  the gradient by loss subset (rgb, + ins, + penalizer), plain and kernel query
  kernel    the kernel query against the plain query: value and gradient, then times
  ops       one flagship train step and one 2048-ray render chunk under torch.profiler:
            the top ops by device time (by kernel name: the port's kernels launch
            through ctypes, so no host op is attributed to them) and by host time, the
            share of the device time in the port's kernels, and the device's idle
            share of the window (1 - the union of device activity over the window's
            host time)
  all       every mode

On the card every time is from CUDA events around ``--iters`` calls after a warm-up;
on the CPU (``--device cpu``) from the host clock, and the ops tables have no device
columns. Each time is printed with the device it was taken on.

CLI:
  python -m dmnerf_tpu_torch.tools.profile_step {stages,backward,kernel,ops,all}
      [--rays 3072] [--ins 32] [--iters 30] [--top 15] [--device cpu] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.compositor import composite
from dmnerf_tpu_torch.core.embedding import positional_encoding
from dmnerf_tpu_torch.core.mlp import dm_nerf_apply
from dmnerf_tpu_torch.core.pipeline import make_query_fn, make_torch_query_fn, render_rays
from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample
from dmnerf_tpu_torch.objfield.losses import img2mse, ins_criterion
from dmnerf_tpu_torch.objfield.penalizer import ins_penalizer
from dmnerf_tpu_torch.render.renderer import make_image_renderer
from dmnerf_tpu_torch.render.trainstep import Batch, create_train_state, make_train_step
from dmnerf_tpu_torch.test import init_params
from dmnerf_tpu_torch.train import profile_trace
from dmnerf_tpu_torch.utils.device import resolve_device

# the device functions of kernels/csrc: K1/K3/K5 (and their STASH forms), the backward's
# launches (K2/K4/K6) and K7
PORT_KERNELS = ("fused_mlp_fwd_kernel", "bwd_data_kernel", "dw_kernel", "sum_rows_kernel",
                "fused_pe_kernel")
# the profiler's own host work inside the window
PROFILER_OWN = ("Activity Buffer Request",)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timer(iters: int, device, results: Dict):
    """``t(name, f, *args)``: ms per call of ``f(*args)``, printed and kept in
    ``results``."""

    def t(name, f, *args):
        f(*args)
        _sync(device)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                f(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                f(*args)
            ms = (time.perf_counter() - t0) / iters * 1e3
        results[name] = ms
        print(f"{name:46s} {ms:8.2f} ms", flush=True)
        return ms

    return t


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"


def _config(n_rays: int, ins_num: int, **kw) -> Config:
    """The flagship model (D=8, W=256, multires 10/4) at the train shape."""
    return Config(N_train=n_rays, N_samples=64, N_importance=128, near=2.0, far=7.0,
                  ins_num=ins_num, **kw)


def _batch(n_rays: int, ins_num: int, device) -> Batch:
    rng = np.random.RandomState(0)
    rays_d = rng.randn(n_rays, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return Batch(t(np.zeros((n_rays, 3), np.float32)), t(rays_d),
                 t(rng.rand(n_rays, 3).astype(np.float32)), t(rng.randint(0, ins_num, n_rays)))


@torch.no_grad()
def profile_stages(n_rays: int, ins_num: int, iters: int, device) -> Dict:
    N, S, SF = n_rays, 64, 192
    cfg = _config(N, ins_num)
    _, pf = init_params(cfg, device)
    rng = np.random.RandomState(0)
    t_ = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    rays_d = t_(rng.randn(N, 3).astype(np.float32))
    rays_o = torch.zeros((N, 3), device=device)
    z_c = z_val_sample(N, cfg.near, cfg.far, S, device=device)
    z_f = torch.sort(t_(rng.rand(N, SF).astype(np.float32)) * 5 + 2, dim=-1).values
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_f[..., None]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    emb_p = positional_encoding(pts_f, 10)
    emb_d = torch.broadcast_to(positional_encoding(viewdirs, 4)[:, None, :], (N, SF, 27))
    raw = t_(rng.randn(N, SF, 4 + ins_num + 1).astype(np.float32))
    weights = t_(rng.rand(N, S).astype(np.float32))
    plain, fused = make_torch_query_fn(), make_query_fn(cfg)
    packed = fused.prepare(pf)
    gen = torch.Generator(device=device).manual_seed(0)

    res = {}
    t = _timer(iters, device, res)
    print(f"== forward stages, N={N} rays, {_device_name(device)} ==")
    t("PE (fine pts)", lambda p: positional_encoding(p, 10), pts_f)
    t("MLP fine (pre-embedded)", dm_nerf_apply, pf, emb_p, emb_d)
    t("PE+MLP fine (plain query)", plain, pf, pts_f, viewdirs)
    t("PE+MLP fine (kernel query, packed)", fused.query, packed, pts_f, viewdirs)
    t("pack parameters", fused.prepare, pf)
    t("composite fine", composite, raw, z_f, rays_d)
    t("sample_pdf (128 from 63 bins)", lambda w: sample_pdf(
        0.5 * (z_c[:, 1:] + z_c[:, :-1]), w[:, 1:-1], 128, generator=gen), weights)
    t("sort union z", lambda a: torch.sort(a, dim=-1), torch.cat([z_c, z_f[:, :128]], -1))
    return res


def _loss(cfg: Config, batch: Batch, z, query, parts, u_z, u_pdf):
    ins_num = cfg.ins_num

    def loss(pc, pf):
        info = render_rays(pc, pf, batch.rays_o, batch.rays_d, z, query, N_importance=128,
                           perturb=True, u_z=u_z, u_pdf=u_pdf)
        total = torch.zeros((), device=z.device)
        if "rgb" in parts:
            total = total + img2mse(info["rgb_fine"], batch.target_c) \
                + img2mse(info["rgb_coarse"], batch.target_c)
        if "ins" in parts:
            total = total + ins_criterion(torch.stack([info["ins_coarse"], info["ins_fine"]]),
                                          batch.target_i, ins_num)[0].sum()
        if "pen" in parts:
            total = total + ins_penalizer(info["raw_coarse"], info["z_vals_coarse"],
                                          info["depth_coarse"], batch.rays_d, 0.05, 0.05) \
                + ins_penalizer(info["raw_fine"], info["z_vals_fine"], info["depth_fine"],
                                batch.rays_d, 0.05, 0.05)
        return total

    return loss


def profile_backward(n_rays: int, ins_num: int, iters: int, device) -> Dict:
    N = n_rays
    cfg = _config(N, ins_num, perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05)
    pc0, pf0 = init_params(cfg, device)
    pc = {k: v.clone().requires_grad_(True) for k, v in pc0.items()}
    pf = {k: v.clone().requires_grad_(True) for k, v in pf0.items()}
    leaves = [*pc.values(), *pf.values()]
    batch = _batch(N, ins_num, device)
    z = z_val_sample(N, cfg.near, cfg.far, cfg.N_samples, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    u_z = torch.rand((N, cfg.N_samples), generator=gen, device=device)
    u_pdf = torch.rand((N, cfg.N_importance), generator=gen, device=device)

    res = {}
    t = _timer(iters, device, res)
    print(f"== backward buckets, N={N} rays, {_device_name(device)} ==")
    for qname, query in (("plain", make_torch_query_fn()), ("kernel", make_query_fn(cfg))):
        def mk(parts):
            return _loss(cfg, batch, z, query, parts, u_z, u_pdf)

        with torch.no_grad():
            t(f"fwd only, rgb loss ({qname})", mk(("rgb",)), pc, pf)
        for parts in (("rgb",), ("rgb", "ins"), ("rgb", "ins", "pen")):
            fn = mk(parts)
            t(f"grad {'+'.join(parts)} ({qname})",
              lambda: torch.autograd.grad(fn(pc, pf), leaves, allow_unused=True))
    return res


def profile_kernel(n_rays: int, ins_num: int, iters: int, device) -> Dict:
    N, S = n_rays, 192
    cfg = _config(N, ins_num)
    _, p0 = init_params(cfg, device)
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.randn(N, S, 3).astype(np.float32)).to(device)
    dirs = rng.randn(N, 3).astype(np.float32)
    dirs = torch.as_tensor(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(device)
    q_plain, q_kernel = make_torch_query_fn(), make_query_fn(cfg)
    w = torch.linspace(0.5, 1.5, 4 + ins_num + 1, device=device)

    def loss(q):
        return lambda: torch.sum(torch.tanh(q(params, pts, dirs)) * w)

    def grads(q):
        return torch.autograd.grad(loss(q)(), list(params.values()))

    with torch.no_grad():
        vx, vk = float(loss(q_plain)()), float(loss(q_kernel)())
    gx, gk = grads(q_plain), grads(q_kernel)
    worst = max(float((a - b).abs().max()) / (float(a.abs().max()) + 1e-12) for a, b in zip(gx, gk))
    print(f"fwd value: plain={vx:.6f} kernel={vk:.6f}")
    print(f"worst grad rel err: {worst:.2e}")

    res = {"value_plain": vx, "value_kernel": vk, "worst_grad_rel_err": worst}
    t = _timer(iters, device, res)
    print(f"== kernel timings, [{N}x{S}], {_device_name(device)} ==")
    with torch.no_grad():
        t("fwd plain", q_plain, params, pts, dirs)
        t("fwd kernel", q_kernel, params, pts, dirs)
    t("grad plain", lambda: grads(q_plain))
    t("grad kernel", lambda: grads(q_kernel))
    return res


def _union_ms(intervals: List) -> float:
    """The length of the union of (start_us, end_us) intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _wall_ms(fn, device) -> float:
    """Median host ms of 5 synchronised calls of ``fn``."""
    times = []
    for _ in range(5):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def op_table(fn, device, top: int = 15) -> Dict:
    """One call of ``fn`` (after one warm-up call) under torch.profiler: the top ops by
    device time (by kernel name) and by host self time, the port's kernels' device ms
    and share, and the device's busy ms (the union of its activity). The idle share is
    of the call's host time without the profiler (``wall_ms``, the median of 5 calls);
    ``profiled_wall_ms`` is the traced call's."""
    fn()
    wall_ms = _wall_ms(fn, device)
    prof = profile_trace(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()

    events = prof.events()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    # a host range the profiler mirrors on the device (a user annotation such as
    # Optimizer.step) carries its host name and overlaps the kernels it spans
    host_names = {e.name for e in events if e not in on_device}
    dev: Dict[str, List[float]] = {}
    intervals = []
    for evt in on_device:
        if evt.name in host_names:
            continue
        r = evt.time_range
        intervals.append((r.start, r.end))
        d = dev.setdefault(evt.name, [0.0, 0])
        d[0] += r.elapsed_us() / 1e3
        d[1] += 1
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.key not in PROFILER_OWN]
    device_ms = sum(v[0] for v in dev.values())
    kernel_ms = sum(v[0] for k, v in dev.items() if any(n in k for n in PORT_KERNELS))
    busy_ms = _union_ms(intervals)
    out = {
        "device": _device_name(device), "wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
        "host_self_ms": sum(h[1] for h in host),
        "device_launches": sum(v[1] for v in dev.values()),
        "top_device": [{"name": k, "ms": v[0], "calls": v[1],
                        "port_kernel": any(n in k for n in PORT_KERNELS)}
                       for k, v in sorted(dev.items(), key=lambda kv: -kv[1][0])[:top]],
        "top_host": [{"name": k, "self_ms": ms, "calls": n}
                     for k, ms, n in sorted(host, key=lambda h: -h[1])[:top]],
    }
    if device.type == "cuda":
        out.update(device_ms=device_ms, port_kernel_ms=kernel_ms,
                   port_kernel_share_of_device=kernel_ms / device_ms if device_ms else 0.0,
                   device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms)
    return out


def _print_table(title: str, t: Dict) -> None:
    print(f"== {title}, {t['device']}: {t['wall_ms']:.2f} ms a call (host clock; "
          f"{t['profiled_wall_ms']:.2f} ms traced), host self time {t['host_self_ms']:.2f} ms ==")
    if "device_ms" in t:
        print(f"device busy {t['device_busy_ms']:.2f} ms in {t['device_launches']:.0f} device "
              f"activities, idle share {t['device_idle_share']:.3f}; "
              f"port kernels {t['port_kernel_ms']:.2f} ms = {t['port_kernel_share_of_device']:.3f} "
              f"of the device time ({t['device_ms']:.2f} ms)")
        print("  top ops by device time:")
        for r in t["top_device"]:
            mark = " [port kernel]" if r["port_kernel"] else ""
            print(f"    {r['ms']:9.3f} ms {r['calls']:6.0f}x  {r['name'][:90]}{mark}")
    print("  top ops by host self time:")
    for r in t["top_host"]:
        print(f"    {r['self_ms']:9.3f} ms {r['calls']:6.0f}x  {r['name'][:90]}")


def profile_ops(n_rays: int, ins_num: int, top: int, device, chunk: int = 2048) -> Dict:
    """One flagship train step (the kernel query, perturb, the penalizer) and one
    render chunk of ``chunk`` rays (the image renderer: sigma-stub coarse and full
    fine query)."""
    cfg = _config(n_rays, ins_num, perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05,
                  N_test=chunk)
    pc, pf = init_params(cfg, device)
    state = create_train_state(cfg, pc, pf)
    step = make_train_step(cfg)
    batch = _batch(n_rays, ins_num, device)
    gen = torch.Generator(device=device).manual_seed(2)
    for _ in range(2):
        step(state, batch, generator=gen)
    train = op_table(lambda: step(state, batch, generator=gen), device, top)
    _print_table(f"train step, {n_rays} rays", train)

    render = make_image_renderer(cfg)
    rb = _batch(cfg.N_test, ins_num, device)
    rays_o = rb.rays_o + torch.tensor([0.0, 0.0, -4.5], device=device)
    chunk = op_table(lambda: render(pc, pf, rays_o, rb.rays_d), device, top)
    _print_table(f"render chunk, {cfg.N_test} rays", chunk)
    return {"train_step": train, "render_chunk": chunk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["stages", "backward", "kernel", "ops", "all"])
    ap.add_argument("--rays", type=int, default=3072)
    ap.add_argument("--ins", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain query is really fp32
    res: Dict[str, Optional[Dict]] = {"device": _device_name(device)}
    if args.mode in ("stages", "all"):
        res["stages"] = profile_stages(args.rays, args.ins, args.iters, device)
    if args.mode in ("backward", "all"):
        res["backward"] = profile_backward(args.rays, args.ins, args.iters, device)
    if args.mode in ("kernel", "all"):
        res["kernel"] = profile_kernel(args.rays, args.ins, args.iters, device)
    if args.mode in ("ops", "all"):
        res["ops"] = profile_ops(args.rays, args.ins, args.top, device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
