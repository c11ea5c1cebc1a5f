"""The bench (the JAX package's ``bench.py``) on the card: train and render throughput,
fp32 and bf16, MFU, and the compiled kernels against the plain query.

    python -m dmnerf_tpu_torch.bench [--kernel-parity]

Prints ONE JSON line on stdout, everything else on stderr:
  {"metric": "train_rays_per_sec", "value": N, "unit": "rays/s", "vs_baseline": null,
   "detail": {"train_fp32": {...}, "train_fp32_dense_ins": {...}, "train_fp32_packed": {...},
              "render_fp32": {...}, "mesh_sigma_fp32": {...}, "mani_render_fp32": {...},
              "mani_render_fp32_2t": {...}, "train_bf16": {...}, "render_bf16": {...},
              "bf16_parity": {...}, "mfu": {...}, "kernel_parity": {...}, ...}}

The geometry is the JAX bench's (``bench.py:42-123``): 3072 rays a step, 64 coarse + 128
fine samples a ray, ins_num 32, the emptiness penalizer, Adam: the whole train step
(``render/trainstep.py``) on a fixed batch; a 256x256 view through the chunked image
renderer; the manipulated view with K = 1 and 2 targets; the 256^3 density sweep of the
mesh mode. ``--kernel-parity`` prints only the kernel section's line.

How each section is timed on the card:
 * train: 3 warm-up steps, then 5 windows of 20 steps, each a host clock around the
   steps that ends in ``torch.cuda.synchronize()``; ``ms_per_step`` is the windows'
   median, ``ms_per_step_windows`` each. One more window of 10 steps under
   ``torch.profiler`` gives ``device_ms_per_step`` (the union of the device's activity,
   a step) and ``device_busy_share`` (that over ``ms_per_step``); nothing is traced
   inside the timed windows. ``psnr_at_5_steps``: 5 steps from the same seeded init
   (generator seed 2), the fine PSNR of the 5th. ``dense_ins`` labels the rays with all
   32 instances, the assignment's (K11's) largest case.
 * packed: ``train.make_packed_steps`` (``render/packing.StepRunner``, one CUDA graph of
   10 whole steps) over a sampler whose batch is the fixed one in static device tensors.
   Its first pack is held to the same 10 steps one at a time, bit for bit
   (``bits_equal_single``); then 1 more pack, and 5 timed packs.
 * views and the sweep: a host clock around synchronised calls after the first (and,
   for the view, 2 settling calls).
 * kernel parity: at the flagship fine-pass shape (3072 x 192 points, seeded fp32 init),
   the kernel query (K1 / K2) against the fp32 plain query with TF32 off, and CUDA
   events around 10 calls of each.

Differences from the JAX bench, on purpose:
 * ``vs_baseline`` is null: its denominator ran the original DM-NeRF code from a
   checkout that is not in the repository (``denominator_kind`` says so).
 * A section that raises is written into the line as ``{"error": ...}`` and the run
   exits 1; so does a ``kernel_parity`` or ``bf16_parity`` whose ``pass`` is false.
 * Numbers are not rounded. Each section also carries ``launches``, the kernel
   launches its wrappers counted (``kernels/runtime.LAUNCHES``; a launch recorded into
   a CUDA graph is not counted), and its wall ``seconds``, set-up included.
 * ``detail`` also carries ``device_count`` and ``power_limit_w`` (``nvidia-smi``).
 * The MFU peak is the card's published dense bf16 rate, by
   ``torch.cuda.get_device_name(0)``; an unknown card gives ``mfu_vs_bf16_peak`` null.

Renamed keys, where the JAX key names a TPU thing (``kernel_parity``): ``fwd_ms_xla`` ->
``fwd_ms_plain``, ``fwd_ms_pallas`` -> ``fwd_ms_kernel``, ``grad_ms_xla`` ->
``grad_ms_plain``, ``grad_ms_pallas`` -> ``grad_ms_kernel``, ``bwd_ms_xla_derived`` ->
``bwd_ms_plain_derived``, ``bwd_ms_pallas_derived`` -> ``bwd_ms_kernel_derived``.

Every section function takes its geometry (``Geometry``) and a device, so the tests run
each at a tiny width on the CPU; the CLI runs ``FLAGSHIP`` on the card and raises
without one (``utils.device.resolve_device``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.embedding import embed_dim
from dmnerf_tpu_torch.core.mlp import init_dm_nerf, rgb_stub_params, sigma_stub_params
from dmnerf_tpu_torch.core.pipeline import make_fused_query_fn, make_torch_query_fn
from dmnerf_tpu_torch.core.rays import rays_from_K
from dmnerf_tpu_torch.kernels import runtime
from dmnerf_tpu_torch.render.manipulator import make_manipulator_renderer
from dmnerf_tpu_torch.render.packing import StepRunner
from dmnerf_tpu_torch.render.renderer import make_image_renderer
from dmnerf_tpu_torch.render.trainstep import Batch, create_train_state, make_train_step
from dmnerf_tpu_torch.test import init_params
from dmnerf_tpu_torch.tools.mesh_extract import DEFAULT_EXTENTS, build_grid, make_sigma_query
from dmnerf_tpu_torch.tools.profile_step import _union_ms
from dmnerf_tpu_torch.train import make_packed_steps, profile_trace
from dmnerf_tpu_torch.utils.device import resolve_device

N_RAYS = 3072
N_SAMPLES = 64
N_IMPORTANCE = 128
INS_NUM = 32
WARMUP = 3
ITERS = 20
RENDER_H = RENDER_W = 256
RENDER_REPS = 5

# published dense bf16 tensor-core rate by torch.cuda.get_device_name: the H100 SXM part
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
PARITY_TOL = 5e-3     # kernel vs fp32 plain: max|d| <= 5e-3 * max(scale, 1) (bench.py:363)
STUB_TOL = 1e-5       # stub columns vs the full model's (bench.py:374, 385)
GRAD_TOL = 2e-2       # per-leaf gradient, max|d| / max|ref| (bench.py:401)
BF16_DPSNR = 1.0      # |psnr@5 bf16 - fp32| < 1 dB (bench.py:565)

# the detail keys of the JAX bench (bench.py:535-587), every one of which this bench writes
JAX_DETAIL_KEYS = ("device_kind", "denominator_kind", "train_fp32", "train_fp32_dense_ins",
                   "train_fp32_packed", "render_fp32", "mesh_sigma_fp32", "mani_render_fp32",
                   "mani_render_fp32_2t", "train_bf16", "render_bf16", "bf16_parity", "mfu",
                   "kernel_parity")
# the sources the sections launch: K1 / K2 (the default pe mode) and K11
KERNELS = ("fused_mlp_fwd", "fused_mlp_bwd", "assignment")
DENOMINATOR = ("none: the JAX bench's denominator ran the original DM-NeRF code from a "
               "checkout that is not in this repository")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shapes a section runs at, and its counts."""
    n_rays: int = N_RAYS
    n_samples: int = N_SAMPLES
    n_importance: int = N_IMPORTANCE
    ins_num: int = INS_NUM
    netdepth: int = 8
    netwidth: int = 256
    n_test: int = 2048           # the render chunk (bench.py:76-78)
    image: int = RENDER_H        # the view is image x image
    grid_dim: int = 256
    warmup: int = WARMUP
    iters: int = ITERS           # steps a timed window
    windows: int = 5
    profile_steps: int = 10
    render_reps: int = RENDER_REPS
    mesh_reps: int = 3
    packs: int = 5               # timed packs of the packed section


FLAGSHIP = Geometry()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_cfg(precision: str, geo: Geometry = FLAGSHIP) -> Config:
    """The JAX bench's config (bench.py:71-80) at ``geo``."""
    return Config(N_train=geo.n_rays, N_samples=geo.n_samples, N_importance=geo.n_importance,
                  N_test=geo.n_test, near=2.0, far=7.0, ins_num=geo.ins_num, perturb=1.0,
                  penalize=True, tolerance=0.05, deta_w=0.05, precision=precision,
                  netdepth=geo.netdepth, netwidth=geo.netwidth)


def make_batch(dense_ins: bool = False, geo: Geometry = FLAGSHIP, device=None) -> Batch:
    """The JAX bench's fixed batch (bench.py:83-103), the same numpy draws:
    ``dense_ins`` labels ray i with i mod ins_num (every instance present), else labels
    are drawn from 8 instances."""
    n = geo.n_rays
    rng = np.random.RandomState(0)
    rays_d = rng.randn(n, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    target_i = np.arange(n) % geo.ins_num if dense_ins else rng.randint(0, 8, size=n)
    target_c = rng.rand(n, 3).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Batch(t(np.zeros((n, 3), np.float32)), t(rays_d), t(target_c),
                 t(target_i.astype(np.int64)))


def analytic_matmul_flops(cfg: Config) -> dict:
    """Per-step matmul FLOPs (2 * in * out a point), forward and train (3x the forward:
    dx and dW), as ``bench.py:106-123`` counts them."""
    D, W = cfg.netdepth, cfg.netwidth
    cp, cv = embed_dim(cfg.multires), embed_dim(cfg.multires_views)
    dims = []
    in_dim = cp
    for i in range(D):
        dims.append((in_dim, W))
        in_dim = W + cp if i in cfg.skips else W
    dims += [(W, 1), (W, W), (W + cv, W // 2), (W // 2, 3),
             (W, W), (W, W // 2), (W // 2, cfg.ins_num + 1)]
    per_point = 2 * sum(i * o for i, o in dims)
    pts_coarse = cfg.N_train * cfg.N_samples
    pts_fine = cfg.N_train * (cfg.N_samples + cfg.N_importance)
    fwd = per_point * (pts_coarse + pts_fine)
    return {"fwd_flops": fwd, "train_flops": 3 * fwd, "per_point_flops": per_point}


def view_rays(geo: Geometry = FLAGSHIP, device=None):
    """The bench view's flat rays (bench.py:247-250): K = [[300, 0, W/2], [0, -300, H/2],
    [0, 0, -1]], c2w = I."""
    H = W = geo.image
    K = torch.tensor([[300.0, 0, W / 2], [0, -300.0, H / 2], [0, 0, -1.0]], device=device)
    ro, rd = rays_from_K(H, W, K, torch.eye(4, device=device))
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def target_bundles(ro: torch.Tensor, rd: torch.Tensor, n_targets: int):
    """(tar_o [K, N, 3], tar_d [K, N, 3], labels): target k translated by 0.25 (k + 1) on
    y, labels 1..K (bench.py:288-291)."""
    offs = [torch.tensor([0.0, 0.25 * (k + 1), 0.0], device=ro.device) for k in range(n_targets)]
    tar_o = torch.stack([ro - off for off in offs])
    tar_d = torch.broadcast_to(rd[None], (n_targets,) + rd.shape)
    return tar_o, tar_d, tuple(range(1, n_targets + 1))


def mesh_grid(geo: Geometry = FLAGSHIP) -> np.ndarray:
    """The sweep's points (bench.py:321): the identity frame, the reference's extents."""
    return build_grid(np.eye(4), DEFAULT_EXTENTS, geo.grid_dim)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Dict[str, int]:
    return {k: n for k, n in runtime.LAUNCHES.items() if n}


def _device_busy_ms(fn: Callable[[], None], device: torch.device) -> Optional[float]:
    """The union of the device's activity while ``fn()`` runs under torch.profiler, in ms;
    None on the CPU, where there is no device to trace."""
    if device.type != "cuda":
        return None
    _sync(device)
    prof = profile_trace(device)
    fn()
    _sync(device)
    prof.stop()
    events = prof.events()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    # a host range mirrored on the device (an annotation) spans the kernels it holds
    host_names = {e.name for e in events if e not in on_device}
    return _union_ms([(e.time_range.start, e.time_range.end) for e in on_device
                      if e.name not in host_names])


def _train_state(cfg: Config, device):
    return create_train_state(cfg, *init_params(cfg, device))


def psnr_after_5_steps(cfg: Config, batch: Batch, device) -> float:
    """The bf16 gate's probe (bench.py:216-233): 5 steps from the seeded init on the fixed
    batch, draws from a device generator seeded 2; the fine PSNR of the 5th step."""
    state = _train_state(cfg, device)
    step = make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(2)
    for _ in range(5):
        aux = step(state, batch, gen)
    return float(aux["psnr_fine"])


def bench_train(precision: str, dense_ins: bool = False, geo: Geometry = FLAGSHIP,
                device=None) -> dict:
    """Train throughput one step at a time on the fixed batch (bench.py:126-164), timed
    and profiled as the module docstring says."""
    device = resolve_device(device)
    cfg = make_cfg(precision, geo)
    runtime.reset_launches()
    state = _train_state(cfg, device)
    step = make_train_step(cfg)
    batch = make_batch(dense_ins, geo, device)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(geo.warmup):
        aux = step(state, batch, gen)
    _sync(device)
    windows = []
    for _ in range(geo.windows):
        t0 = time.perf_counter()
        for _ in range(geo.iters):
            aux = step(state, batch, gen)
        _sync(device)
        windows.append((time.perf_counter() - t0) / geo.iters * 1e3)
    ms = statistics.median(windows)
    loss = float(aux["total_loss"])
    launches = _launches()

    def profiled():
        for _ in range(geo.profile_steps):
            step(state, batch, gen)

    busy = _device_busy_ms(profiled, device)
    device_ms = None if busy is None else busy / geo.profile_steps
    out = {"ms_per_step": ms, "rays_per_sec": geo.n_rays / ms * 1e3, "loss": loss,
           "ms_per_step_windows": windows, "steps_per_window": geo.iters,
           "device_ms_per_step": device_ms,
           "device_busy_share": None if device_ms is None else device_ms / ms,
           "launches": launches}
    if dense_ins:
        out["n_instances_present"] = geo.ins_num
        out["psnr_at_5_steps"] = None
    else:
        out["psnr_at_5_steps"] = psnr_after_5_steps(cfg, batch, device)
    log(f"[bench] train {precision}{' dense_ins' if dense_ins else ''}: {ms:.2f} ms/step "
        f"(windows {', '.join(f'{w:.2f}' for w in windows)}), {out['rays_per_sec']:,.0f} "
        f"rays/s, device {device_ms} ms/step (loss {loss:.4f}, psnr@5 {out['psnr_at_5_steps']})")
    return out


def fixed_batch_sampler(batch: Batch, n_train: int):
    """A sampler (``data/samplers.py``'s ``draw`` / ``gather``) whose every batch is
    ``batch``: ``draw`` gives ``1 + n_train`` zero ids, ``gather`` returns the batch's own
    device tensors, so a captured step reads them in place and touches no host value."""
    ids = torch.zeros(1 + n_train, dtype=torch.long)

    def draw(generator=None) -> torch.Tensor:
        return ids

    def gather(_ids: torch.Tensor) -> Batch:
        return batch

    def sample(generator=None) -> Batch:
        return batch

    sample.draw, sample.gather = draw, gather
    return sample


def bench_train_packed(precision: str, pack: int = 10, geo: Geometry = FLAGSHIP,
                       device=None) -> dict:
    """Packed train throughput (``steps_per_dispatch``, bench.py:167-213): one CUDA graph
    of ``pack`` whole steps on the card (eager steps from the same buffers on the CPU)."""
    device = resolve_device(device)
    cfg = make_cfg(precision, geo).replace(steps_per_dispatch=pack, i_print=pack)
    batch = make_batch(False, geo, device)
    sampler = fixed_batch_sampler(batch, cfg.N_train)
    gen_batch = torch.Generator()

    # the pack's first losses against the same steps one at a time, from the same state
    single = StepRunner(cfg, sampler, make_train_step(cfg), device, 1)
    ref_state, gen = _train_state(cfg, device), torch.Generator(device=device).manual_seed(1)
    single_losses = torch.cat([single(ref_state, gen_batch, gen)["total_loss"].clone()
                               for _ in range(pack)])
    del ref_state, single

    runtime.reset_launches()
    packed, P = make_packed_steps(cfg, sampler, None, device)
    state, gen = _train_state(cfg, device), torch.Generator(device=device).manual_seed(1)
    losses = packed(state, gen_batch, gen)["total_loss"].clone()
    bits_equal = bool(torch.equal(losses.view(torch.int32), single_losses.view(torch.int32)))
    packed(state, gen_batch, gen)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(geo.packs):
        last = packed(state, gen_batch, gen)["total_loss"]
    _sync(device)
    dt = time.perf_counter() - t0
    ms = dt / (geo.packs * P) * 1e3
    out = {"ms_per_step": ms, "rays_per_sec": geo.n_rays / ms * 1e3, "steps_per_dispatch": P,
           "loss": float(last[-1]), "timed_packs": geo.packs,
           "first_pack_losses": losses.tolist(), "single_step_losses": single_losses.tolist(),
           "bits_equal_single": bits_equal, "launches": _launches()}
    log(f"[bench] train {precision} packed x{P}: {ms:.2f} ms/step, {out['rays_per_sec']:,.0f} "
        f"rays/s (loss {out['loss']:.4f}); first pack bit for bit the single steps: {bits_equal}")
    return out


def _timed_calls(fn: Callable[[], object], reps: int, device, settle: int = 0) -> float:
    """ms a call: ``fn()`` once (and ``settle`` more), then ``reps`` calls under a host
    clock that ends in a synchronise."""
    for _ in range(1 + settle):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def bench_render(precision: str, geo: Geometry = FLAGSHIP, device=None) -> dict:
    """A view through the chunked image renderer (bench.py:236-266)."""
    device = resolve_device(device)
    cfg = make_cfg(precision, geo)
    pc, pf = init_params(cfg, device)
    renderer = make_image_renderer(cfg)
    ro, rd = view_rays(geo, device)
    runtime.reset_launches()
    out = {}

    def view():
        out.update(renderer(pc, pf, ro, rd))

    ms = _timed_calls(view, geo.render_reps, device, settle=2)
    n_rays = geo.image * geo.image
    log(f"[bench] render {precision}: {ms:.1f} ms/image ({geo.image}x{geo.image}), "
        f"{n_rays / ms * 1e3:,.0f} rays/s")
    return {"ms_per_image": ms, "rays_per_sec": n_rays / ms * 1e3,
            "image": f"{geo.image}x{geo.image}", "rgb_finite": bool(torch.isfinite(out["rgb"]).all()),
            "launches": _launches()}


def bench_mani_render(precision: str, n_targets: int = 1, geo: Geometry = FLAGSHIP,
                      device=None) -> dict:
    """A manipulated view (the two-pass union-z exchange, bench.py:269-304) with
    ``n_targets`` moved objects."""
    device = resolve_device(device)
    cfg = make_cfg(precision, geo)
    pc, pf = init_params(cfg, device)
    mani = make_manipulator_renderer(cfg, n_targets=n_targets)
    ro, rd = view_rays(geo, device)
    tar_o, tar_d, labels = target_bundles(ro, rd, n_targets)
    runtime.reset_launches()
    out = {}

    def view():
        out.update(mani(pc, pf, ro, rd, tar_o, tar_d, labels))

    ms = _timed_calls(view, geo.render_reps, device)
    n_rays = geo.image * geo.image
    log(f"[bench] mani_render {precision}: {ms:.1f} ms/image ({geo.image}x{geo.image}, "
        f"{n_targets} target(s)), {n_rays / ms * 1e3:,.0f} rays/s")
    return {"ms_per_image": ms, "rays_per_sec": n_rays / ms * 1e3,
            "image": f"{geo.image}x{geo.image}", "n_targets": n_targets,
            "rgb_finite": bool(torch.isfinite(out["rgb"]).all()), "launches": _launches()}


def bench_mesh_sigma(precision: str, geo: Geometry = FLAGSHIP, device=None) -> dict:
    """The mesh mode's density sweep over grid_dim^3 points (bench.py:307-334), through
    ``tools/mesh_extract.make_sigma_query`` (the sigma stub, chunks of 65,536 points)."""
    device = resolve_device(device)
    cfg = make_cfg(precision, geo)
    _, pf = init_params(cfg, device)
    grid = torch.as_tensor(mesh_grid(geo), device=device)
    query = make_sigma_query(cfg)
    runtime.reset_launches()
    out = {}

    def sweep():
        out["sigma"] = query(pf, grid)

    ms = _timed_calls(sweep, geo.mesh_reps, device)
    n = geo.grid_dim ** 3
    log(f"[bench] mesh_sigma {precision}: {ms:.1f} ms / {geo.grid_dim}^3 grid "
        f"({n / ms / 1e3:,.1f} Mpts/s)")
    return {"ms_per_sweep": ms, "mpts_per_sec": n / ms / 1e3, "grid": f"{geo.grid_dim}^3",
            "sigma_finite": bool(torch.isfinite(out["sigma"]).all()), "launches": _launches()}


def _event_ms(fn: Callable[[], object], reps: int = 10) -> float:
    """ms a call from CUDA events around ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_kernel_parity(geo: Geometry = FLAGSHIP, device=None) -> dict:
    """The compiled kernel query (K1 forward, K2 backward) against the fp32 plain query
    at the fine-pass shape (bench.py:337-431): the forward, the sigma and rgb stubs'
    columns, the per-leaf gradients of sum(tanh(raw) * w), and the times of both."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("kernel parity runs on a CUDA device: on the CPU the kernel "
                           "query is its plain version, so there is nothing to hold")
    N, S = geo.n_rays, geo.n_samples + geo.n_importance
    params = init_dm_nerf(ins_num=geo.ins_num, D=geo.netdepth, W=geo.netwidth,
                          generator=torch.Generator().manual_seed(0), device=device)
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.uniform(-3, 3, (N, S, 3)).astype(np.float32), device=device)
    dirs = rng.randn(N, 3).astype(np.float32)
    dirs = torch.as_tensor(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True), device=device)
    plain = make_torch_query_fn(D=geo.netdepth)
    kernel = make_fused_query_fn(D=geo.netdepth)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain query is really fp32
    runtime.reset_launches()
    try:
        with torch.no_grad():
            a = plain(params, pts, dirs)
            b = kernel(params, pts, dirs)
            stub = kernel(sigma_stub_params(params), pts, dirs)
            rstub = kernel(rgb_stub_params(params), pts, dirs)
        max_err = float((a - b).abs().max())
        scale = float(a.abs().max())
        sigma_scale = float(a[..., 3].abs().max())
        stub_err = float((stub[..., 3] - b[..., 3]).abs().max())
        si_scale = float(a[..., 3:].abs().max())
        rstub_err = float((rstub[..., 3:] - b[..., 3:]).abs().max())
        del a, b, stub, rstub

        w = torch.linspace(0.5, 1.5, 4 + geo.ins_num + 1, device=device)
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

        def grads(q):
            loss = torch.sum(torch.tanh(q(leaves, pts, dirs)) * w)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        g_plain, g_kernel = grads(plain), grads(kernel)
        bwd_rel = max(float((g_plain[k] - g_kernel[k]).abs().max())
                      / (float(g_plain[k].abs().max()) + 1e-12) for k in leaves)
        del g_plain, g_kernel
        launches = _launches()

        def fwd(q):
            with torch.no_grad():
                q(params, pts, dirs)

        fwd_plain, fwd_kernel = _event_ms(lambda: fwd(plain)), _event_ms(lambda: fwd(kernel))
        grad_plain, grad_kernel = _event_ms(lambda: grads(plain)), _event_ms(lambda: grads(kernel))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    fwd_ok = max_err <= PARITY_TOL * max(scale, 1.0)
    stub_ok = stub_err <= STUB_TOL * max(sigma_scale, 1.0)
    rstub_ok = rstub_err <= STUB_TOL * max(si_scale, 1.0)
    bwd_ok = bwd_rel <= GRAD_TOL
    ok = fwd_ok and bwd_ok and stub_ok and rstub_ok
    log(f"[bench] kernel parity: fwd max|d| {max_err:.2e} (scale {scale:.1f}), bwd max rel "
        f"{bwd_rel:.2e}, sigma-stub max|d| {stub_err:.2e}, rgb-stub max|d| {rstub_err:.2e} -> "
        f"{'PASS' if ok else 'FAIL'}; fwd ms plain {fwd_plain:.2f} kernel {fwd_kernel:.2f}; "
        f"fwd+bwd ms plain {grad_plain:.2f} kernel {grad_kernel:.2f}")
    return {"pass": ok, "max_abs_err": max_err, "out_scale": scale,
            "bwd_max_rel_err": bwd_rel, "bwd_pass": bwd_ok,
            "sigma_stub_max_abs_err": stub_err, "sigma_stub_pass": stub_ok,
            "rgb_stub_max_abs_err": rstub_err, "rgb_stub_pass": rstub_ok,
            "fwd_ms_plain": fwd_plain, "fwd_ms_kernel": fwd_kernel,
            "grad_ms_plain": grad_plain, "grad_ms_kernel": grad_kernel,
            "bwd_ms_plain_derived": grad_plain - fwd_plain,
            "bwd_ms_kernel_derived": grad_kernel - fwd_kernel,
            "points": N * S, "launches": launches}


def power_limit_w() -> Optional[float]:
    """The first card's power limit from ``nvidia-smi``, in W; None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30).stdout
        return float(out.splitlines()[0].split(",")[-1].strip().split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device_kind": "cpu", "device_count": 0, "power_limit_w": None}
    return {"device_kind": torch.cuda.get_device_name(device),
            "device_count": torch.cuda.device_count(), "power_limit_w": power_limit_w()}


def mfu(detail: dict, geo: Geometry) -> dict:
    """Achieved matmul TFLOP/s of each train section and its share of the card's dense
    bf16 peak (bench.py:569-581)."""
    flops = analytic_matmul_flops(make_cfg("float32", geo))
    peak = PEAK_BF16.get(detail["device_kind"])
    out = {}
    for k in ("train_fp32", "train_fp32_packed", "train_bf16"):
        d = detail.get(k, {})
        if "ms_per_step" in d:
            achieved = flops["train_flops"] / (d["ms_per_step"] / 1e3)
            out[k] = {"achieved_tflops": achieved / 1e12,
                      "mfu_vs_bf16_peak": achieved / peak if peak else None}
    out["analytic_train_gflops_per_step"] = flops["train_flops"] / 1e9
    out["peak_bf16_tflops"] = peak / 1e12 if peak else None
    out["note"] = ("matmul FLOPs only (a lower bound on the work); the kernels multiply in "
                   "bf16 whatever precision is, so train_fp32 is fp32 parameters on bf16 "
                   "tensor-core products")
    return out


def _section(detail: dict, name: str, fn: Callable[[], dict]) -> None:
    """``detail[name] = fn()`` with the section's wall ``seconds``, or ``{"error": ...}``
    with the traceback on stderr."""
    t0 = time.perf_counter()
    try:
        detail[name] = fn()
    except Exception as e:     # a failed section is reported in the line and fails the run
        traceback.print_exc(file=sys.stderr)
        detail[name] = {"error": repr(e)}
        return
    detail[name]["seconds"] = time.perf_counter() - t0


def failures(detail: dict) -> list:
    """The sections of ``detail`` that raised or whose gate failed."""
    bad = [k for k, v in detail.items() if isinstance(v, dict) and "error" in v]
    bad += [k for k in ("kernel_parity", "bf16_parity")
            if isinstance(detail.get(k), dict) and detail[k].get("pass") is False and k not in bad]
    return bad


def bf16_parity(detail: dict) -> dict:
    """|psnr@5 bf16 - psnr@5 fp32| < 1 dB (bench.py:563-565)."""
    a = detail.get("train_bf16", {}).get("psnr_at_5_steps")
    b = detail.get("train_fp32", {}).get("psnr_at_5_steps")
    if a is None or b is None:
        return {"pass": False, "error": "train_bf16 or train_fp32 has no psnr_at_5_steps"}
    dpsnr = abs(a - b)
    return {"dpsnr_at_5_steps": dpsnr, "pass": bool(dpsnr < BF16_DPSNR)}


def run(device: torch.device, geo: Geometry = FLAGSHIP) -> dict:
    """Every section at ``geo`` on ``device``; the detail block."""
    detail = {**device_info(device), "denominator_kind": DENOMINATOR}
    _section(detail, "train_fp32", lambda: bench_train("float32", geo=geo, device=device))
    _section(detail, "train_fp32_dense_ins",
             lambda: bench_train("float32", dense_ins=True, geo=geo, device=device))
    _section(detail, "train_fp32_packed",
             lambda: bench_train_packed("float32", geo=geo, device=device))
    _section(detail, "render_fp32", lambda: bench_render("float32", geo, device))
    _section(detail, "mesh_sigma_fp32", lambda: bench_mesh_sigma("float32", geo, device))
    _section(detail, "mani_render_fp32", lambda: bench_mani_render("float32", 1, geo, device))
    _section(detail, "mani_render_fp32_2t", lambda: bench_mani_render("float32", 2, geo, device))
    _section(detail, "train_bf16", lambda: bench_train("bfloat16", geo=geo, device=device))
    _section(detail, "render_bf16", lambda: bench_render("bfloat16", geo, device))
    detail["bf16_parity"] = bf16_parity(detail)
    detail["mfu"] = mfu(detail, geo)
    _section(detail, "kernel_parity", lambda: bench_kernel_parity(geo, device))
    return detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel-parity", action="store_true",
                    help="run and print only the kernel parity section")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    if device.type == "cuda":
        runtime.build(KERNELS)      # one nvcc a source, all started together
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):    # stdout carries the one line
        if args.kernel_parity:
            detail = {}
            _section(detail, "kernel_parity", lambda: bench_kernel_parity(FLAGSHIP, device))
            res = detail["kernel_parity"]
            line = {"metric": "kernel_parity_max_abs_err", "value": res.get("max_abs_err"),
                    "unit": "abs", "vs_baseline": None, "detail": res}
        else:
            detail = run(device)
            line = {"metric": "train_rays_per_sec",
                    "value": detail["train_fp32"].get("rays_per_sec"), "unit": "rays/s",
                    "vs_baseline": None, "detail": detail}
    bad = failures(detail)
    if bad:
        log(f"[bench] FAILED: {', '.join(bad)}")
    print(json.dumps(line), file=out, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
