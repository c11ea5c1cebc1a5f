"""Manipulation entry points (``dmnerf_tpu/render/mani_eval.py``): evaluation against
the manipulated ground truth, and the multi-object demo. In a process group of more than
one the views render sharded over the ranks
(``parallel.mesh.make_sharded_manipulator_renderer``).

 * ``manipulator_eval``: one rigid edit (the target bundle is rendered from
   trans @ ori_pose), a chunked full-image manipulation render per view, PSNR / SSIM /
   LPIPS and instance mAP against the manipulated GT, the per-view pred->GT matching
   log, RGB / instance / GT image dumps, test_results.txt and matching_log.json. The
   single edit is a K=1 bundle list.
 * ``manipulator_demo``: per-object transform series from ``tools.pose_gen`` (rigid)
   or deformable ray-origin warps (sin / e^x / linear / abs_linear / ln row profiles
   scaled by the 8-phase deform_v ramp), K simultaneous objects, frame dumps.

The importance sampling is stochastic as in the JAX package: view i draws from a
``torch.Generator`` on the device seeded with i, where the JAX package folds i into
PRNGKey(0); the two give different draws. ``save_dir=None`` writes nothing. Both
return per-view render seconds (host clock around a synchronised render).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.rays import rays_from_K
from dmnerf_tpu_torch.objfield.metrics import compact_gt_one_hot_np, ins_eval
from dmnerf_tpu_torch.render.manipulator import deform_ray_offsets, make_manipulator_renderer
from dmnerf_tpu_torch.tools.visualizer import render_gt_label2img, render_label2img
from dmnerf_tpu_torch.utils.device import resolve_device, world_size
from dmnerf_tpu_torch.utils.image_io import imwrite as _imwrite
from dmnerf_tpu_torch.utils.image_metrics import lpips_np, psnr_np, ssim_np, to8b
from dmnerf_tpu_torch.utils.metrics_log import write_matching_log, write_test_results

# 8-phase deformation ramp of the demo
DEFORM_V = np.concatenate([np.linspace(0, 0.18, 2), np.linspace(0.18, 0, 2),
                           np.linspace(0, -0.18, 2), np.linspace(-0.18, 0, 2)])


def _make_mani_renderer(cfg: Config, n_targets: int, device):
    """The single-device manipulation renderer, or the ray-sharded one in a process group
    of more than one."""
    if world_size() > 1:
        from dmnerf_tpu_torch.parallel.mesh import make_mesh, make_sharded_manipulator_renderer

        return make_sharded_manipulator_renderer(cfg, make_mesh(device=device), n_targets)
    return make_manipulator_renderer(cfg, n_targets)


def _flat_rays(H, W, K, c2w, device):
    K_t = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    c2w_t = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
    o, d = rays_from_K(H, W, K_t, c2w_t)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _render(run, params_coarse, params_fine, ori_o, ori_d, tar_os, tar_ds, labels, i, device):
    """One view through the renderer with view i's generator; (outputs on the host,
    render seconds)."""
    t0 = time.time()
    out = run(params_coarse, params_fine, ori_o, ori_d, torch.stack(tar_os),
              torch.stack(tar_ds), tuple(labels),
              generator=torch.Generator(device=device).manual_seed(i))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return out, time.time() - t0


def manipulator_eval(
    cfg: Config,
    params_coarse,
    params_fine,
    ori_poses: np.ndarray,
    hwk,
    trans_dicts: List[Dict],
    save_dir: Optional[str],
    ins_rgbs: np.ndarray,
    gt_rgbs: Optional[np.ndarray] = None,
    gt_labels: Optional[np.ndarray] = None,
    color_dict: Optional[Dict] = None,
    target_label: Optional[int] = None,
    device=None,
) -> Dict:
    """Renders every pose with the first of ``trans_dicts`` applied to
    ``target_label`` (default cfg.target_label) on ``device`` (default: the CUDA card;
    the parameters must already be there). Returns psnrs, ssims, lpipses, aps [V, 6],
    full_map, images and times."""
    device = resolve_device(device)
    H, W, K = hwk
    if color_dict is None:
        color_dict = {str(i): i for i in range(cfg.ins_num)}
    target_label = target_label if target_label is not None else cfg.target_label
    if target_label is None:
        raise ValueError("mani_eval needs a target_label")

    trans_dict = trans_dicts[0]
    trans = np.asarray(trans_dict["transformation"], np.float32)
    if save_dir is not None:
        save_dir = os.path.join(save_dir, trans_dict["mode"])
        os.makedirs(save_dir, exist_ok=True)

    run = _make_mani_renderer(cfg, 1, device)
    psnrs, ssims, lpipses, aps, images, times, full_map = [], [], [], [], [], [], {}
    for i, ori_pose in enumerate(np.asarray(ori_poses)):
        ori_o, ori_d = _flat_rays(H, W, K, ori_pose, device)
        tar_o, tar_d = _flat_rays(H, W, K, trans @ ori_pose, device)
        out, dt = _render(run, params_coarse, params_fine, ori_o, ori_d, [tar_o], [tar_d],
                          [int(target_label)], i, device)
        times.append(dt)
        rgb = out["rgb"].reshape(H, W, 3)
        ins = out["ins"].reshape(H, W, -1)   # air channel kept
        images.append(rgb)

        ins_map = {}
        if gt_rgbs is not None:
            gt_img = np.asarray(gt_rgbs[i])
            gt_label = np.asarray(gt_labels[i])
            psnrs.append(psnr_np(rgb, gt_img))
            ssims.append(ssim_np(rgb, gt_img))
            lpipses.append(lpips_np(rgb, gt_img, device=device))
            gt_onehot, valid_gt_num, valid_gt_labels = compact_gt_one_hot_np(gt_label, cfg.ins_num)
            if valid_gt_num > 0:
                # the air channel is dropped for the evaluation
                _, ap, matched = ins_eval(ins[..., :-1], gt_onehot, valid_gt_num, cfg.ins_num)
                ins_map = {str(int(m)): int(g) for m, g in zip(matched, valid_gt_labels) if m != -1}
            else:
                ap = [1.0] * 6
            full_map[i] = ins_map
            aps.append(ap)
            print(f"[mani_eval] view {i}: PSNR {psnrs[-1]:.3f} AP {ap}")

        if save_dir is not None:
            label = np.argmax(ins, axis=-1)
            _imwrite(os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb))
            _imwrite(os.path.join(save_dir, f"{i}_ins.png"),
                     render_label2img(label, ins_rgbs, color_dict, ins_map))
            if gt_rgbs is not None:
                _imwrite(os.path.join(save_dir, f"{i}_rgb_gt.png"), to8b(np.asarray(gt_rgbs[i])))
                _imwrite(os.path.join(save_dir, f"{i}_ins_gt.png"),
                         render_gt_label2img(np.asarray(gt_labels[i]), ins_rgbs, color_dict))
        print(f"[mani_eval] IMAGE[{i}] TIME: {dt:.3f}s")

    if gt_rgbs is not None and aps and save_dir is not None:
        write_matching_log(save_dir, full_map)
        write_test_results(save_dir, psnrs, ssims, lpipses, np.asarray(aps))
    return {"psnrs": psnrs, "ssims": ssims, "lpipses": lpipses,
            "aps": np.asarray(aps) if aps else None, "full_map": full_map,
            "images": images, "times": times}


def manipulator_demo(
    cfg: Config,
    params_coarse,
    params_fine,
    hwk,
    objs_trans: Dict,
    save_dir: Optional[str],
    ins_rgbs: np.ndarray,
    objs: List[Dict],
    view_poses: np.ndarray,
    ins_map: Dict,
    color_dict: Optional[Dict] = None,
    device=None,
) -> Dict:
    """Renders frame i of every object's edit at view_poses[i], all K objects at once.
    A rigid object takes objs_trans[obj_name][i]; a 'deform' object shifts the ray
    origins' x by ``deform_ray_offsets`` at DEFORM_V[i % 8]. Returns images (rgb),
    labels and times."""
    device = resolve_device(device)
    H, W, K = hwk
    if color_dict is None:
        color_dict = {str(i): i for i in range(cfg.ins_num)}
    if save_dir is not None:
        save_dir = os.path.join(save_dir, "mani_output")
        os.makedirs(save_dir, exist_ok=True)

    run = _make_mani_renderer(cfg, len(objs), device)
    images, labels_out, times = [], [], []
    for i, ori_pose in enumerate(np.asarray(view_poses)):
        ori_o, ori_d = _flat_rays(H, W, K, ori_pose, device)
        tar_os, tar_ds, labels = [], [], []
        for obj in objs:
            labels.append(int(obj["tar_id"]))
            if obj["mani_mode"] == "deform":
                off = deform_ray_offsets(H, W, obj["deform_func"], DEFORM_V[i % len(DEFORM_V)])
                to = ori_o.clone()
                to[:, 0] += torch.from_numpy(off).to(device)
                tar_os.append(to)
                tar_ds.append(ori_d)
            else:
                trans = np.asarray(objs_trans[obj["obj_name"]][i]["transformation"], np.float32)
                to, td = _flat_rays(H, W, K, trans @ ori_pose, device)
                tar_os.append(to)
                tar_ds.append(td)

        out, dt = _render(run, params_coarse, params_fine, ori_o, ori_d, tar_os, tar_ds,
                          labels, i, device)
        times.append(dt)
        rgb = out["rgb"].reshape(H, W, 3)
        label = np.argmax(out["ins"].reshape(H, W, -1), axis=-1)
        images.append(rgb)
        labels_out.append(label)
        if save_dir is not None:
            _imwrite(os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb))
            _imwrite(os.path.join(save_dir, f"{i}_ins.png"),
                     render_label2img(label, ins_rgbs, color_dict, ins_map))
            _imwrite(os.path.join(save_dir, f"{i}_ins_pred_mask.png"), label.astype(np.uint8))
        print(f"[mani_demo] Image{i}: {dt:.3f}s")
    return {"images": images, "labels": labels_out, "times": times}
