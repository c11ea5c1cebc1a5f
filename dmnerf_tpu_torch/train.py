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

Steps run one by one. ``steps_per_dispatch`` packs TPU dispatches in the JAX package
and leaves the trajectory unchanged, so it changes nothing here. ``multihost`` raises
NotImplementedError. With ``profile_dir`` the steps ``profile_start`` to
``profile_start + profile_steps - 1`` run under ``torch.profiler`` (host and, on the
card, device activity), and their Chrome trace is written under ``profile_dir``
(``profile_trace``). ``debug_nans`` stops the run with
FloatingPointError at the first step whose loss or parameter gradients are not finite,
before Adam applies them (render.trainstep.check_finite).

Usage:  python -m dmnerf_tpu_torch.train --config configs/train/dmsr/study.txt [key=value ...]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config, dump_config, parse_cli
from dmnerf_tpu_torch.data.samplers import make_crop_sampler, make_full_sampler
from dmnerf_tpu_torch.data.scene import SceneData, load_scene
from dmnerf_tpu_torch.render.evaluation import render_test
from dmnerf_tpu_torch.render.trainstep import TrainState, create_train_state, make_train_step
from dmnerf_tpu_torch.test import init_params
from dmnerf_tpu_torch.utils.checkpoint import (
    load_checkpoint, resolve_ckpt_path, restore_checkpoint, save_checkpoint)
from dmnerf_tpu_torch.utils.device import resolve_device
from dmnerf_tpu_torch.utils.metrics_log import MetricsLogger


def _state_from(cfg: Config, loaded) -> TrainState:
    pc, pf, step, opt_state = loaded
    state = create_train_state(cfg, pc, pf, step)
    if opt_state is not None:
        state.opt.load_state_dict(opt_state)
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


def train(cfg: Config, scene: Optional[SceneData] = None, device=None) -> TrainState:
    """Train on ``device`` (default: the CUDA card) and return the final state."""
    device = resolve_device(device)
    if cfg.multihost or os.environ.get("DMNERF_MULTIHOST", "") == "1":
        raise NotImplementedError("multi-host training is not ported yet "
                                  "(ROADMAP.md queue 1, 'Multi-GPU')")
    if scene is None:
        scene = load_scene(cfg)
    if cfg.steps_per_dispatch > 1:
        print(f"[train] steps_per_dispatch={cfg.steps_per_dispatch} packs TPU dispatches in the "
              "JAX package; here the same steps run one by one")
    cfg = cfg.replace(ins_num=scene.ins_num)
    log_dir = cfg.log_dir
    os.makedirs(log_dir, exist_ok=True)
    dump_config(cfg, log_dir)
    logger = MetricsLogger(log_dir)

    state = create_train_state(cfg, *init_params(cfg, device))
    if cfg.resume:
        restored = restore_checkpoint(log_dir, device)
        if restored is not None:
            state = _state_from(cfg, restored)
            print(f"[train] resumed from step {state.step}")
    if cfg.ft_path:
        # the exact checkpoint the path names, never a silent substitute
        path, step = resolve_ckpt_path(cfg.ft_path)
        state = _state_from(cfg, load_checkpoint(path, device))
        if state.step != step:
            raise ValueError(f"checkpoint {path} carries step={state.step}, its name says {step}")
        print(f"[train] fine-tuning from {cfg.ft_path} (step {state.step})")

    sampler, n_ins = make_sampler(cfg, scene, device)
    step_fn = make_train_step(cfg, N_ins=n_ins)
    gen_batch = torch.Generator().manual_seed(cfg.seed + 1)
    gen_step = torch.Generator(device=device).manual_seed(cfg.seed + 2)

    t_last = time.time()
    rays_done = 0
    prof, prof_from = None, None
    for i in range(state.step, cfg.N_iters):
        if cfg.profile_dir is not None:
            if i == cfg.profile_start:
                prof, prof_from = profile_trace(device), i
            elif prof is not None and i == cfg.profile_start + cfg.profile_steps:
                _write_trace(prof, cfg, device, prof_from, i - 1)
                prof = None
        aux = step_fn(state, sampler(gen_batch), generator=gen_step)
        rays_done += cfg.N_train

        if i % cfg.i_print == 0:
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
            print(f"[train] checkpoint {_save(log_dir, state)}")

        if i > 0 and i % cfg.i_test == 0 and len(scene.i_test) > 0:
            n_views = min(10, len(scene.i_test))
            sel = np.random.default_rng(i).choice(len(scene.i_test), size=n_views, replace=False)
            ids = scene.i_test[sel]
            render_test(cfg, state.params_coarse, state.params_fine, scene.poses[ids], scene.hwk,
                        gt_imgs=scene.images[ids], gt_labels=scene.gt_labels[ids],
                        ins_rgbs=scene.ins_rgbs, savedir=os.path.join(log_dir, f"testset_{i:06d}"),
                        crop_mask=scene.crop_mask, device=device)

    if prof is not None:
        _write_trace(prof, cfg, device, prof_from, cfg.N_iters - 1)
    _save(log_dir, state)
    logger.close()
    return state


def main(argv=None):
    train(parse_cli(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
