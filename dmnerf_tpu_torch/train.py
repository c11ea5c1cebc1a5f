"""Training entry point (``dmnerf_tpu/train.py``).

One entry point for every dataset (a config field). Per step: a random train image's
ray batch (data.samplers), the coarse + fine render with gradients, RGB MSE +
Hungarian instance loss (+ the emptiness penalizer), Adam with exponential LR decay
(render.trainstep). Every ``i_print`` steps a line and a ``metrics.jsonl`` record,
every ``i_save`` a checkpoint with the Adam state, every ``i_test`` an evaluation of
up to 10 random test views. A run resumes from its latest checkpoint; ``ft_path``
wins over resume.

A scene with a crop mask and labelled pixel ids (ScanNet) trains on the crop
sampler, whose labelled rays form the batch suffix that the instance loss sees
(``N_ins``); every other scene on the full-image sampler.

Each step runs from inputs drawn ahead into static buffers (``render.packing``).
``steps_per_dispatch`` packs P = gcd(steps_per_dispatch, i_print) whole steps into one
dispatch, as the JAX package packs them into one ``lax.scan``: on the card one CUDA graph
replay a pack, on the CPU the same P steps eagerly; the trajectory is the one by one
trajectory, bit for bit. A pack starts on a multiple of P, fits in N_iters and holds no
checkpoint boundary, no evaluation boundary when the scene has test views, and none is
taken under ``profile_dir`` (``pack_ok``); a print boundary logs the pack's first aux.

Several GPUs: one process a card in a ``torch.distributed`` group (``parallel.mesh``).
``torchrun`` (``WORLD_SIZE`` > 1), ``multihost`` or ``$DMNERF_MULTIHOST=1`` join the group
from the environment (``env://``; across hosts too), each rank on ``cuda:{LOCAL_RANK}``.
In a group of more than one the steps are sharded over the ranks when N_train is a
multiple of the world size (``build_sampler_and_step``; otherwise every rank runs the
unsharded step, loudly), and the evaluations render sharded. Every rank reads a
checkpoint to resume; only rank 0 writes checkpoints, ``metrics.jsonl``, images and
traces. With ``profile_dir`` the steps ``profile_start`` to
``profile_start + profile_steps - 1`` run under ``torch.profiler`` (host and, on the
card, device activity), and their Chrome trace is written under ``profile_dir``
(``profile_trace``). ``debug_nans`` stops the run with
FloatingPointError at the first step whose loss or parameter gradients are not finite,
before Adam applies them (render.trainstep.check_finite).

With ``$DMNERF_REPORT`` set, a resumed run prints the digest of the state it restored
(``utils.checkpoint.state_digest``) and the command prints its kernel launches and peak
device memory as a last line, each as ``[report] {...}`` (``utils.metrics_log.report``),
for a parent that drives the command (``scripts/e2e_cycle_torch.py``).

Usage:  python -m dmnerf_tpu_torch.train --config configs/train/dmsr/study.txt [key=value ...]
        [--device cpu]    (default: the CUDA card; without one it raises)
        torchrun --nproc_per_node=N -m dmnerf_tpu_torch.train --config ... [key=value ...]
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config, dump_config, parse_cli
from dmnerf_tpu_torch.data.samplers import make_crop_sampler, make_full_sampler
from dmnerf_tpu_torch.data.scene import SceneData, load_scene
from dmnerf_tpu_torch.parallel.mesh import (
    Mesh, init_process_group, make_mesh, make_packed_sharded_steps, make_sharded_train_step,
    multi_process)
from dmnerf_tpu_torch.render.evaluation import render_test
from dmnerf_tpu_torch.render.packing import StepRunner
from dmnerf_tpu_torch.render.trainstep import (
    TrainState, create_train_state, load_adam_state, make_train_step)
from dmnerf_tpu_torch.test import init_params
from dmnerf_tpu_torch.kernels import runtime
from dmnerf_tpu_torch.utils.checkpoint import (
    load_checkpoint, resolve_ckpt_path, restore_checkpoint, save_checkpoint, state_digest)
from dmnerf_tpu_torch.utils.device import is_writer, pop_device_flag, resolve_device
from dmnerf_tpu_torch.utils.metrics_log import MetricsLogger, report, report_wanted


def _state_from(cfg: Config, loaded) -> TrainState:
    pc, pf, step, opt_state = loaded
    state = create_train_state(cfg, pc, pf, step)
    if opt_state is not None:
        load_adam_state(state.opt, opt_state)
    return state


def _save(log_dir: str, state: TrainState) -> str:
    return save_checkpoint(log_dir, state.params_coarse, state.params_fine, state.step,
                           state.opt.state_dict())


def profile_trace(device) -> torch.profiler.profile:
    """A started torch.profiler over host and, on the card, device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _write_trace(prof, cfg: Config, device, first: int, last: int) -> str:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(cfg.profile_dir, exist_ok=True)
    path = os.path.join(cfg.profile_dir, f"train_steps_{first:06d}-{last:06d}.json")
    prof.export_chrome_trace(path)
    print(f"[train] wrote profiler trace to {path}")
    return path


def make_sampler(cfg: Config, scene: SceneData, device):
    """(sampler, N_ins): the crop sampler exactly when the scene has a crop mask and
    labelled pixel ids, else the full-image sampler and None."""
    if scene.crop_mask is not None and scene.ins_indices is not None:
        return make_crop_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                                 scene.i_train, cfg.N_train, scene.ins_indices,
                                 scene.crop_mask, device=device)
    return make_full_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                             scene.i_train, cfg.N_train, device=device), None


def make_packed_steps(cfg: Config, sampler, n_ins: Optional[int], device,
                      mesh: Optional[Mesh] = None):
    """``(packed_fn, P)``, where ``packed_fn(state, gen_batch, gen_step)`` runs P whole
    train steps (``render.packing.StepRunner``) and returns their auxs as [P] tensors,
    or None when the pack would be one step. P = gcd(steps_per_dispatch, i_print), so
    print boundaries land on pack starts (``dmnerf_tpu/train.py:94-125``). ``mesh``: the
    P steps are sharded steps (``parallel.mesh.make_packed_sharded_steps``)."""
    P = math.gcd(cfg.steps_per_dispatch, cfg.i_print)
    if P != cfg.steps_per_dispatch:
        print(f"[train] steps_per_dispatch={cfg.steps_per_dispatch} reduced to "
              f"gcd with i_print={cfg.i_print}: effective pack size {P}")
    if P <= 1:
        print("[train] steps_per_dispatch: effective pack size 1 — packing disabled")
        return None
    if mesh is not None:
        return make_packed_sharded_steps(cfg, sampler, n_ins, mesh, P), P
    return StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), resolve_device(device), P), P


def build_sampler_and_step(cfg: Config, scene: SceneData, device, mesh: Optional[Mesh] = None):
    """``(sampler, single, n_ins, packed)`` (``dmnerf_tpu/train.py:54-96``): ``single`` runs
    one step (a ``StepRunner`` of one), ``packed`` is ``make_packed_steps``'s or None. In
    a mesh of more than one (default: the process group that is up) the steps are
    sharded when N_train is a multiple of its size; otherwise every rank runs the
    unsharded step, and says so loudly."""
    device = resolve_device(device)
    mesh = make_mesh(device=device) if mesh is None else mesh
    n_devices = mesh.size
    sampler, n_ins = make_sampler(cfg, scene, device)
    sharded = None
    if n_devices > 1 and cfg.N_train % n_devices == 0:
        sharded = mesh
        step = make_sharded_train_step(cfg, mesh, N_ins=n_ins)
        if is_writer():
            print(f"[train] sharded over {n_devices}-device mesh {mesh.shape}")
    else:
        if n_devices > 1 and is_writer():
            bar = "!" * 70
            print(f"[train] {bar}\n"
                  f"[train] WARNING: N_train={cfg.N_train} is NOT divisible by the "
                  f"{n_devices} visible devices.\n"
                  f"[train] FALLING BACK TO SINGLE-DEVICE training "
                  f"(~{n_devices}x throughput lost).\n"
                  f"[train] Set N_train to a multiple of {n_devices} to shard over "
                  f"the mesh.\n[train] {bar}")
        step = make_train_step(cfg, N_ins=n_ins)
    single = StepRunner(cfg, sampler, step, device, 1)
    packed = (make_packed_steps(cfg, sampler, n_ins, device, sharded)
              if cfg.steps_per_dispatch > 1 else None)
    return sampler, single, n_ins, packed



def pack_ok(cfg: Config, i: int, P: int, has_test_views: bool) -> bool:
    """A pack [i, i + P) may replace P single steps only when it starts on a pack
    boundary, fits the schedule, runs without ``profile_dir`` and holds no checkpoint
    or evaluation boundary, whose artifacts must see the state mid-pack; an evaluation
    boundary counts only when the scene has test views (``dmnerf_tpu/train.py:175-190``)."""
    if i % P != 0 or i + P > cfg.N_iters or cfg.profile_dir is not None:
        return False
    return not any(j > 0 and (j % cfg.i_save == 0 or (has_test_views and j % cfg.i_test == 0))
                   for j in range(i, i + P))


def train(cfg: Config, scene: Optional[SceneData] = None, device=None) -> TrainState:
    """Train on ``device`` (default: the CUDA card, ``cuda:{LOCAL_RANK}`` under
    ``torchrun``) and return the final state."""
    device = resolve_device(device)
    if multi_process(cfg):
        mesh = init_process_group(device)
        print(f"[train] multi-process: rank {mesh.rank}/{mesh.size} on {mesh.device}")
    if scene is None:
        scene = load_scene(cfg)
    cfg = cfg.replace(ins_num=scene.ins_num)
    log_dir = cfg.log_dir
    if is_writer():
        os.makedirs(log_dir, exist_ok=True)
        dump_config(cfg, log_dir)
    logger = MetricsLogger(log_dir)

    state = create_train_state(cfg, *init_params(cfg, device))
    if cfg.resume:
        restored = restore_checkpoint(log_dir, device)
        if restored is not None:
            state = _state_from(cfg, restored)
            print(f"[train] resumed from step {state.step}")
            if report_wanted():
                report(resumed_step=state.step, digest=state_digest(
                    state.params_coarse, state.params_fine, state.opt.state_dict()))
    if cfg.ft_path:
        # the exact checkpoint the path names, never a silent substitute
        path, step = resolve_ckpt_path(cfg.ft_path)
        state = _state_from(cfg, load_checkpoint(path, device))
        if state.step != step:
            raise ValueError(f"checkpoint {path} carries step={state.step}, its name says {step}")
        print(f"[train] fine-tuning from {cfg.ft_path} (step {state.step})")

    _, single, _, packed = build_sampler_and_step(cfg, scene, device)
    P = packed[1] if packed is not None else 1
    has_test_views = len(scene.i_test) > 0
    gen_batch = torch.Generator().manual_seed(cfg.seed + 1)
    gen_step = torch.Generator(device=device).manual_seed(cfg.seed + 2)

    t_last = time.time()
    rays_done = 0
    prof, prof_from = None, None
    i = state.step
    while i < cfg.N_iters:
        if cfg.profile_dir is not None and is_writer():
            if i == cfg.profile_start:
                prof, prof_from = profile_trace(device), i
            elif prof is not None and i == cfg.profile_start + cfg.profile_steps:
                _write_trace(prof, cfg, device, prof_from, i - 1)
                prof = None
        if packed is not None and pack_ok(cfg, i, P, has_test_views):
            auxs, stepped = packed[0](state, gen_batch, gen_step), P
        else:
            auxs, stepped = single(state, gen_batch, gen_step), 1
        aux = {k: v[0] for k, v in auxs.items()}     # the aux of iteration i
        rays_done += cfg.N_train * stepped

        if i % cfg.i_print == 0 and is_writer():
            aux = {k: float(v) for k, v in aux.items()}
            dt = time.time() - t_last
            rays_s = rays_done / dt if dt > 0 else 0.0
            rays_done, t_last = 0, time.time()
            print(f"[TRAIN] Iter: {i} F_PSNR: {aux['psnr_fine']:.3f} C_PSNR: "
                  f"{aux['psnr_coarse']:.3f} Total: {aux['total_loss']:.4f} RGB: "
                  f"{aux['rgb_loss']:.4f} Ins: {aux['ins_loss']:.4f} Reg: "
                  f"{aux['emptiness_loss']:.4f} rays/s: {rays_s:,.0f}")
            logger.log(i, {**aux, "rays_per_sec": rays_s})

        if i > 0 and i % cfg.i_save == 0:
            path = _save(log_dir, state)
            if is_writer():
                print(f"[train] checkpoint {path}")

        if i > 0 and i % cfg.i_test == 0 and len(scene.i_test) > 0:
            n_views = min(10, len(scene.i_test))
            sel = np.random.default_rng(i).choice(len(scene.i_test), size=n_views, replace=False)
            ids = scene.i_test[sel]
            render_test(cfg, state.params_coarse, state.params_fine, scene.poses[ids], scene.hwk,
                        gt_imgs=scene.images[ids], gt_labels=scene.gt_labels[ids],
                        ins_rgbs=scene.ins_rgbs,
                        savedir=os.path.join(log_dir, f"testset_{i:06d}") if is_writer() else None,
                        crop_mask=scene.crop_mask, verbose=is_writer(), device=device)
        i += stepped

    if prof is not None:
        _write_trace(prof, cfg, device, prof_from, cfg.N_iters - 1)
    _save(log_dir, state)
    logger.close()
    return state


def main(argv=None):
    device, argv = pop_device_flag(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    train(parse_cli(argv), device=device)
    report(launches=dict(runtime.LAUNCHES),
           peak_device_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None))


if __name__ == "__main__":
    main()
