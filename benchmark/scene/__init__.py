"""The scene of a configuration, made from the run's seed (``make_scene``).

A configuration's ``scene`` block names its kind and sizes:

 * ``dmsr``: views on a circle of ``camera_radius`` around the spheres, the blender
   convention (K with negative fy and K22 = -1, the DM-SR loader's ``dmsr_intrinsics``
   from ``camera_angle_x``), labels 0 (sky) and 1 ... ``objects``;
 * ``scannet``: OpenCV poses and positive intrinsics (``focal``), raw labels 0 ...
   ``objects`` - 1, the sky and a ``unlabeled_frac`` share of the pixels unlabelled and
   so the air label ``objects`` (= ins_num), a centre crop of ``crop_width`` x
   ``crop_height``, and per train view the ids of its labelled pixels inside the crop in
   an order drawn from the seed (the loader's ``selected_pixels`` at ``weakly_value`` 1).

The program and the reference are handed the same arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from benchmark.scene.synthetic import CV_FLIP, orbit_poses, render_views, sphere_spec


@dataclasses.dataclass
class Scene:
    images: torch.Tensor           # [M, H, W, 3] float32 on the device
    labels: torch.Tensor           # [M, H, W] int64
    poses: torch.Tensor            # [M, 4, 4]
    K: torch.Tensor                # [3, 3]
    H: int
    W: int
    i_train: np.ndarray
    i_test: np.ndarray
    ins_num: int
    ins_indices: Optional[List[np.ndarray]] = None   # scannet: labelled ids per train view
    crop_mask: Optional[np.ndarray] = None            # scannet: [H, W] int8


def _crop_mask(H: int, W: int, crop_w: int, crop_h: int) -> np.ndarray:
    mask = np.zeros((H, W), np.int8)
    mh, mw = (H - crop_h) // 2, (W - crop_w) // 2
    mask[mh:H - mh, mw:W - mw] = 1
    return mask


def make_scene(conf: dict, gen: torch.Generator) -> Scene:
    """The configuration's scene from ``gen`` (a generator on the scene's device)."""
    s = conf["scene"]
    dev = gen.device
    H, W, n_tr, n_te = s["H"], s["W"], s["train_views"], s["test_views"]
    spec = sphere_spec(s["objects"], s["spread"], gen)
    poses = torch.cat([orbit_poses(n_tr, s["camera_radius"], s["camera_height"], 0.0, dev),
                       orbit_poses(n_te, s["camera_radius"], s["camera_height"],
                                   math.pi / n_tr, dev)])
    i_train, i_test = np.arange(n_tr), np.arange(n_tr, n_tr + n_te)
    if s["kind"] == "dmsr":
        focal = 0.5 * W / math.tan(0.5 * s["camera_angle_x"])
        K = torch.tensor([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], device=dev)
        images, labels = render_views(poses, H, W, K, spec)
        return Scene(images, labels, poses, K, H, W, i_train, i_test, conf["ins_num"])
    if s["kind"] != "scannet":
        raise ValueError(f"unknown scene kind {s['kind']!r}")
    focal = s["focal"]
    K = torch.tensor([[focal, 0, W * 0.5], [0, focal, H * 0.5], [0, 0, 1]], device=dev)
    poses = poses @ CV_FLIP.to(dev)
    images, labels = render_views(poses, H, W, K, spec)
    air = s["objects"]
    labels = labels - 1                                     # raw: sphere k -> k, sky -1
    unlabeled = torch.rand(labels.shape, generator=gen, device=dev) < s["unlabeled_frac"]
    labels = torch.where((labels < 0) | unlabeled, air, labels)
    crop = _crop_mask(H, W, s["crop_width"], s["crop_height"])
    crop_t = torch.as_tensor(crop.reshape(-1) == 1, device=dev)
    ins_indices = []
    for v in i_train:
        ids = torch.nonzero((labels[v].reshape(-1) != air) & crop_t)[:, 0]
        order = torch.randperm(ids.numel(), generator=gen, device=dev)
        ins_indices.append(ids[order].cpu().numpy())
    return Scene(images, labels, poses, K, H, W, i_train, i_test, air, ins_indices, crop)
