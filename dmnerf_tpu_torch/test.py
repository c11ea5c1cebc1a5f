"""Evaluation entry point (``dmnerf_tpu/test.py``), dispatched on config flags.

``render`` renders the test views and evaluates them; ``mani_eval`` renders the
manipulated test views of ``mani_mode`` against the manipulated ground truth
(``indoor_{mani_mode}_test``); ``mani_demo`` renders the objects of objs_info.json
moving over ``views`` frames; ``mesh`` sweeps the fine model's density over a
``mesh_grid_dim``^3 grid, extracts the iso-surface at ``mesh_level`` and colours its
vertices by instance (tools.mesh_extract). The query's kernel pair follows
``pallas_pe_mode``. ``run_test`` returns what the mode's function returns.

Under ``torchrun`` (``WORLD_SIZE`` > 1) or ``multihost`` each rank joins the process
group (``parallel.mesh``) and the mode renders sharded over the ranks; every rank reads
the checkpoint, and only rank 0 writes (images, ``test_results.txt``, PLY files, the pose
files), the others waiting for it at a barrier.

With ``$DMNERF_REPORT`` set, the command prints its kernel launches as a last line
``[report] {"launches": {...}}`` (``utils.metrics_log.report``).

Usage:  python -m dmnerf_tpu_torch.test --config configs/test/dmsr/study.txt [key=value ...]
        [--device cpu]    (default: the CUDA card; without one it raises)
        torchrun --nproc_per_node=N -m dmnerf_tpu_torch.test --config ... [key=value ...]
"""

from __future__ import annotations

import json
import os
import sys

import torch

from dmnerf_tpu_torch.configs import Config, parse_cli
from dmnerf_tpu_torch.core.embedding import embed_dim
from dmnerf_tpu_torch.core.mlp import init_dm_nerf
from dmnerf_tpu_torch.data.scene import load_scene
from dmnerf_tpu_torch.kernels import runtime
from dmnerf_tpu_torch.parallel.mesh import init_process_group, multi_process
from dmnerf_tpu_torch.render.evaluation import render_test
from dmnerf_tpu_torch.utils.checkpoint import load_checkpoint, resolve_ckpt_path, restore_checkpoint
from dmnerf_tpu_torch.utils.device import barrier, is_writer, pop_device_flag, resolve_device
from dmnerf_tpu_torch.utils.metrics_log import report

def load_color_dict(cfg: Config):
    """data/color_dict.json keyed [dataset][scene]; else a per-scene
    color_dict.json; else identity."""
    parts = os.path.normpath(cfg.datadir).split(os.sep)
    scene_name = parts[-1] if parts else cfg.expname
    dataset_name = parts[-2] if len(parts) > 1 else cfg.dataset_type
    for candidate in (
        os.path.join(os.path.dirname(os.path.dirname(cfg.datadir)), "color_dict.json"),
        "./data/color_dict.json",
    ):
        if os.path.exists(candidate):
            with open(candidate) as f:
                d = json.load(f)
            if dataset_name in d and scene_name in d[dataset_name]:
                return d[dataset_name][scene_name]
    local = os.path.join(cfg.datadir, "color_dict.json")
    if os.path.exists(local):
        with open(local) as f:
            return json.load(f)
    return {str(i): i for i in range(cfg.ins_num)}


def init_params(cfg: Config, device=None):
    """Seeded (params_coarse, params_fine): one generator seeded with cfg.seed
    draws the coarse model, then the fine one."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    kwargs = dict(
        ins_num=cfg.ins_num, D=cfg.netdepth, W=cfg.netwidth,
        input_ch_pts=embed_dim(cfg.multires if cfg.i_embed == 0 else -1),
        input_ch_views=embed_dim(cfg.multires_views if cfg.i_embed == 0 else -1),
        skips=tuple(cfg.skips),
        dtype=torch.bfloat16 if cfg.precision == "bfloat16" else torch.float32,
        generator=gen, device=device,
    )
    return init_dm_nerf(**kwargs), init_dm_nerf(**kwargs)


def load_params(cfg: Config, device=None):
    """(params_coarse, params_fine, step): the ft_path checkpoint, else the latest
    under the run dir, else (loudly) the seeded init."""
    device = resolve_device(device)
    if cfg.ft_path:
        path, step = resolve_ckpt_path(cfg.ft_path)
        pc, pf, loaded, _ = load_checkpoint(path, device)
        if loaded != step:
            raise ValueError(f"checkpoint {path} carries step={loaded}, its name says {step}")
        print(f"[test] loaded checkpoint step {step} from ft_path {cfg.ft_path}")
        return pc, pf, step
    if not cfg.no_reload:
        restored = restore_checkpoint(cfg.log_dir, device)
        if restored is not None:
            print(f"[test] loaded checkpoint step {restored[2]} from {cfg.log_dir}")
            return restored[:3]
        print(f"[test] WARNING: no checkpoint under {cfg.log_dir}; using init params")
    pc, pf = init_params(cfg, device)
    return pc, pf, 0


def run_test(cfg: Config, device=None, scene=None):
    """Run the config's test mode on ``device`` (default: the CUDA card) over ``scene``
    (default: the config's dataset, read from ``datadir``)."""
    device = resolve_device(device)
    if multi_process(cfg):
        init_process_group(device)
    result = _run_mode(cfg, device, scene)
    barrier()
    return result


def _savedir(cfg: Config, name: str):
    """The mode's output directory under the run, made by rank 0; None on the others,
    which write nothing."""
    if not is_writer():
        return None
    savedir = os.path.join(cfg.log_dir, name)
    os.makedirs(savedir, exist_ok=True)
    return savedir


def _run_mode(cfg: Config, device, scene):
    if scene is None and cfg.mani_eval:
        from dmnerf_tpu_torch.data.dmsr_mani import load_dmsr_mani

        scene = load_dmsr_mani(cfg)
    elif scene is None:
        scene = load_scene(cfg)
    cfg = cfg.replace(ins_num=scene.ins_num, perturb=0.0)
    params_coarse, params_fine, iteration = load_params(cfg, device)
    color_dict = load_color_dict(cfg)

    if cfg.render:
        savedir = _savedir(cfg, f"render_{'test' if cfg.render_test else 'path'}_{iteration:06d}")
        ids = scene.i_test
        result = render_test(
            cfg, params_coarse, params_fine, scene.poses[ids], scene.hwk,
            gt_imgs=scene.images[ids], gt_labels=scene.gt_labels[ids],
            ins_rgbs=scene.ins_rgbs, savedir=savedir, crop_mask=scene.crop_mask,
            color_dict=color_dict, verbose=is_writer(), device=device,
        )
        print("Rendering Done", savedir)

    elif cfg.mani_eval:
        from dmnerf_tpu_torch.data.dmsr_mani import load_mani_poses
        from dmnerf_tpu_torch.render.mani_eval import manipulator_eval
        from dmnerf_tpu_torch.tools.pose_gen import generate_poses_eval

        if is_writer():
            generate_poses_eval(cfg)
        barrier()
        savedir = _savedir(cfg, f"mani_eval_{iteration:06d}")
        result = manipulator_eval(
            cfg, params_coarse, params_fine, scene.poses, scene.hwk,
            trans_dicts=load_mani_poses(cfg.datadir), save_dir=savedir,
            ins_rgbs=scene.ins_rgbs, gt_rgbs=scene.images, gt_labels=scene.gt_labels,
            color_dict=color_dict, device=device,
        )
        print("Manipulating Done", savedir)

    elif cfg.mani_demo:
        from dmnerf_tpu_torch.data.dmsr_mani import load_obj_poses
        from dmnerf_tpu_torch.render.mani_eval import manipulator_demo
        from dmnerf_tpu_torch.tools.pose_gen import generate_poses_demo

        if is_writer():
            generate_poses_demo(scene.objs, cfg)
        barrier()
        savedir = _savedir(cfg, f"mani_demo_{iteration:06d}")
        result = manipulator_demo(
            cfg, params_coarse, params_fine, scene.hwk,
            objs_trans=load_obj_poses(cfg.datadir), save_dir=savedir,
            ins_rgbs=scene.ins_rgbs, objs=scene.objs, view_poses=scene.view_poses,
            ins_map=scene.ins_map, color_dict=color_dict, device=device,
        )
        print("Manipulating Done", savedir)

    elif cfg.mesh:
        from dmnerf_tpu_torch.tools.mesh_extract import mesh_main

        savedir = _savedir(cfg, f"mesh_{iteration:06d}")
        result = mesh_main(cfg, params_coarse, params_fine, scene.ins_rgbs, savedir,
                           ins_map=scene.ins_map, color_dict=color_dict,
                           grid_dim=cfg.mesh_grid_dim, level=cfg.mesh_level, device=device)
        print("Meshing Done", savedir)
    else:
        print("no eval mode selected (render / mani_eval / mani_demo / mesh)")
        result = None
    return result


def main(argv=None):
    device, argv = pop_device_flag(sys.argv[1:] if argv is None else argv)
    run_test(parse_cli(argv), device)
    report(launches=dict(runtime.LAUNCHES))


if __name__ == "__main__":
    main()
