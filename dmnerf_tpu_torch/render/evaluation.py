"""Test-set rendering and evaluation (``dmnerf_tpu/render/evaluation.py``,
single-device branch).

Per test pose: a chunked full-image render (render.renderer) -> PSNR / SSIM / LPIPS
against the GT image, per-view instance mAP (objfield.metrics.ins_eval) and the
pred->GT label map. ScanNet crop path: GT and prediction restricted to the crop,
eval with the < ins_num validity mask. Files: per-view RGB, instance, GT instance
and GT mask PNGs, matching_log.json and test_results.txt (9 columns + mean row).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.rays import rays_from_K
from dmnerf_tpu_torch.objfield.metrics import compact_gt_one_hot_np, ins_eval
from dmnerf_tpu_torch.render.renderer import make_image_renderer
from dmnerf_tpu_torch.tools.visualizer import render_gt_label2img, render_label2img
from dmnerf_tpu_torch.utils.device import resolve_device
from dmnerf_tpu_torch.utils.image_metrics import lpips_np, psnr_np, ssim_np, to8b
from dmnerf_tpu_torch.utils.metrics_log import write_matching_log, write_test_results


def _imwrite(path: str, img: np.ndarray) -> None:
    import imageio.v2 as imageio

    imageio.imwrite(path, img)


def render_test(
    cfg: Config,
    params_coarse,
    params_fine,
    render_poses: np.ndarray,      # [V, 4, 4]
    hwk,
    gt_imgs: Optional[np.ndarray] = None,
    gt_labels: Optional[np.ndarray] = None,
    ins_rgbs: Optional[np.ndarray] = None,
    savedir: Optional[str] = None,
    crop_mask: Optional[np.ndarray] = None,
    color_dict: Optional[Dict] = None,
    renderer=None,
    verbose: bool = True,
    device=None,
) -> Dict:
    """Renders every pose on ``device`` (default: the CUDA card; the parameters
    must already be there) and evaluates against the GT when given. Returns
    psnrs, ssims, lpipses, aps [V, 6], full_map, images and the render seconds
    of each view (``times``, host clock around a synchronised render)."""
    device = resolve_device(device)
    H, W, K = hwk
    if renderer is None:
        renderer = make_image_renderer(cfg)
    if color_dict is None:
        color_dict = {str(i): i for i in range(cfg.ins_num)}

    crop = None
    if crop_mask is not None:
        crop = np.asarray(crop_mask).reshape(-1) == 1
        ch, cw = cfg.crop_height, cfg.crop_width

    psnrs, ssims, lpipses, aps, times = [], [], [], [], []
    full_map = {}
    out_images = []
    K_t = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)

    for i, c2w in enumerate(np.asarray(render_poses)):
        t0 = time.time()
        c2w_t = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=device)
        rays_o, rays_d = rays_from_K(H, W, K_t, c2w_t)
        out = renderer(params_coarse, params_fine, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))
        rgb = out["rgb"].cpu().numpy()
        ins = out["ins"].cpu().numpy()
        times.append(time.time() - t0)

        if crop is not None:
            rgb = rgb[crop].reshape(ch, cw, 3)
            ins = ins[crop].reshape(ch, cw, ins.shape[-1])
        else:
            rgb = rgb.reshape(H, W, 3)
            ins = ins.reshape(H, W, ins.shape[-1])
        out_images.append(rgb)

        pred_label = np.argmax(ins, axis=-1)
        ins_map = {}
        if gt_imgs is not None:
            gt_img = np.asarray(gt_imgs[i])
            gt_label = np.asarray(gt_labels[i])
            if crop is not None:
                gt_img = gt_img.reshape(-1, 3)[crop].reshape(ch, cw, 3)
                gt_label = gt_label.reshape(-1)[crop].reshape(ch, cw)

            psnrs.append(psnr_np(rgb, gt_img))
            ssims.append(ssim_np(rgb, gt_img))
            lpipses.append(lpips_np(rgb, gt_img, device=device))

            gt_onehot, valid_gt_num, valid_gt_labels = compact_gt_one_hot_np(
                gt_label, cfg.ins_num, drop_last=crop is not None)
            if valid_gt_num > 0:
                mask = (gt_label < cfg.ins_num).astype(np.float32) if crop is not None else None
                pred_label, ap, matched = ins_eval(ins, gt_onehot, valid_gt_num, cfg.ins_num, mask)
                ins_map = {str(int(m)): int(g) for m, g in zip(matched, valid_gt_labels) if m != -1}
            else:
                # shaped like the (possibly cropped) rendered label plane
                pred_label = -1 * np.ones(gt_label.shape, dtype=np.int64)
                ap = [1.0] * 6
            full_map[i] = ins_map
            aps.append(ap)
            if verbose:
                print(f"[eval] view {i}: PSNR {psnrs[-1]:.3f} SSIM {ssims[-1]:.4f} "
                      f"AP@.5 {ap[0]:.3f} ({times[-1]:.2f}s)")

        if savedir is not None:
            os.makedirs(savedir, exist_ok=True)
            _imwrite(os.path.join(savedir, f"{i:03d}.png"), to8b(rgb))
            if ins_rgbs is not None:
                ins_img = render_label2img(pred_label, ins_rgbs, color_dict, ins_map)
                _imwrite(os.path.join(savedir, f"instance_{i:03d}.png"), ins_img)
                if gt_labels is not None:
                    gt_ins_img = render_gt_label2img(gt_label, ins_rgbs, color_dict)
                    _imwrite(os.path.join(savedir, f"{i}_ins_gt.png"), gt_ins_img)
                    _imwrite(os.path.join(savedir, f"{i}_ins_gt_mask.png"),
                             gt_label.astype(np.uint8))

    results = {"psnrs": psnrs, "ssims": ssims, "lpipses": lpipses,
               "aps": np.asarray(aps) if aps else None, "full_map": full_map,
               "images": out_images, "times": times}
    if gt_imgs is not None and savedir is not None and aps:
        write_matching_log(savedir, full_map)
        write_test_results(savedir, psnrs, ssims, lpipses, np.asarray(aps))
    if gt_imgs is not None and aps and verbose:
        a = np.asarray(aps).mean(0)
        lp = ("n/a (weights absent, see docs/LPIPS.md)"
              if np.all(np.isnan(lpipses)) else f"{np.nanmean(lpipses):.4f}")
        print(f"[eval] mean PSNR {np.nanmean(psnrs):.4f} SSIM {np.nanmean(ssims):.4f} "
              f"LPIPS {lp} mAP {a}")
    return results
