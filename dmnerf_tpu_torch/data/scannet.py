"""ScanNet (noisy real-world) dataset loader (``dmnerf_tpu/data/scannet.py``).

 * {split}_split_idx.txt frame indices; {split}/{split}_images/{i}.jpg RGB;
   {split}/{split}_pose/{i}.txt 4x4 OpenCV camera-to-world poses;
   {split}/{split}_ins/{i}.npz instance maps (key ins_2d_label_id, -1 unlabelled);
 * with ``resize``, a nearest-neighbour resize to 640x480 (``resize_nearest``, the
   index map of OpenCV's INTER_NEAREST written in numpy) and the intrinsics of
   intrinsic/intrinsic_depth.txt; else intrinsic_color.txt;
 * labels: ins_num = (number of distinct labels) - 1; the palette cut to ins_num;
   unlabelled -1 remapped to ins_num ("air");
 * the centre crop mask of size (crop_width, crop_height) (``crop_mask_for``);
 * weakly supervised pixel selection: per train image, the labelled pixel ids inside
   the crop, subsampled by weakly_value with numpy's ``default_rng(cfg.seed)``
   (``selected_pixels``), the same draws as the JAX package's.

``scene_from_arrays`` is everything after the file reads, so
``data.synthetic.build_scannet_scene`` builds the same SceneData in memory. imageio
and h5py are imported inside the functions that read files.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.data.dmsr import _read_image, load_palette
from dmnerf_tpu_torch.data.scene import SceneData

RESIZE_HW = (480, 640)


def crop_mask_for(H: int, W: int, crop_w: int, crop_h: int) -> np.ndarray:
    """Centre crop mask [H, W] int8: 1 inside the (crop_w x crop_h) window."""
    mask = np.zeros((H, W), np.int8)
    mh, mw = (H - crop_h) // 2, (W - crop_w) // 2
    mask[mh:H - mh, mw:W - mw] = 1
    return mask


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """Source index of each destination index under OpenCV's INTER_NEAREST:
    floor(x * (1 / (dst / src))) in double precision, clamped to the last index."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def resize_nearest(data: np.ndarray, H: int = RESIZE_HW[0], W: int = RESIZE_HW[1]) -> np.ndarray:
    """Nearest-neighbour resize of a stack [M, h, w, ...] to [M, H, W, ...], equal to
    ``cv2.resize(d, (W, H), interpolation=cv2.INTER_NEAREST)`` image by image."""
    rows = _nearest_index(data.shape[1], H)
    cols = _nearest_index(data.shape[2], W)
    return data[:, rows][:, :, cols]


def selected_pixels(full_ins: np.ndarray, ins_num: int, crop_mask: np.ndarray,
                    weakly_value: float = 1.0,
                    rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
    """Per image, the flat indices of labelled pixels inside the crop, subsampled by
    weakly_value without replacement."""
    if rng is None:
        rng = np.random.default_rng(0)
    flat = full_ins.reshape(full_ins.shape[0], -1)
    crop_flat = crop_mask.reshape(-1)
    all_hws = []
    for ins in flat:
        ins = ins.copy()
        ins[crop_flat == 0] = ins_num
        labeled = np.where(ins != ins_num)[0]
        sel = rng.choice(len(labeled), size=int(len(labeled) * weakly_value), replace=False)
        all_hws.append(labeled[sel])
    return all_hws


def intrinsics_file(cfg: Config) -> str:
    """The intrinsics the loader reads: the depth camera's when the frames are
    resized to its 640x480, the colour camera's otherwise."""
    return os.path.join("intrinsic", "intrinsic_depth.txt" if cfg.resize
                        else "intrinsic_color.txt")


def scene_from_arrays(cfg: Config, train, test, intr: np.ndarray,
                      palette: np.ndarray) -> SceneData:
    """The SceneData of a ScanNet scene from its arrays: ``train`` and ``test`` are
    (rgb [M, h, w, 3] float32 in [0, 1], c2w [M, 4, 4], raw labels [M, h, w] with -1
    unlabelled), the test split already subsampled by testskip; ``intr`` is the 4x4
    of ``intrinsics_file(cfg)``."""
    images = np.concatenate([train[0], test[0]], 0)
    poses = np.concatenate([train[1], test[1]], 0).astype(np.float32)
    gt_labels = np.concatenate([train[2], test[2]], 0).astype(np.int32)
    if cfg.resize:
        images = resize_nearest(images).astype(np.float32)
        gt_labels = resize_nearest(gt_labels)

    n_train = len(train[0])
    i_train = np.arange(n_train)
    i_test = np.arange(n_train, len(images))

    ins_num = len(np.unique(gt_labels)) - 1      # drop the -1 unlabelled marker
    ins_rgbs = palette[:ins_num]
    gt_labels[gt_labels == -1] = ins_num          # air

    H, W = images.shape[1:3]
    crop_mask = crop_mask_for(H, W, cfg.crop_width, cfg.crop_height)
    ins_indices = selected_pixels(gt_labels[i_train], ins_num, crop_mask, cfg.weakly_value,
                                  rng=np.random.default_rng(cfg.seed))
    return SceneData(
        images=images, poses=poses, H=int(H), W=int(W),
        K=np.asarray(intr)[:3, :3].astype(np.float32), i_train=i_train, i_test=i_test,
        gt_labels=gt_labels, ins_rgbs=ins_rgbs, ins_num=ins_num,
        ins_indices=ins_indices, crop_mask=crop_mask,
    )


def load_scannet(cfg: Config) -> SceneData:
    basedir = cfg.datadir

    def _split(split: str, skip: int):
        idx = np.loadtxt(os.path.join(basedir, f"{split}_split_idx.txt")).astype(np.int32).reshape(-1)
        root = os.path.join(basedir, split)
        rgbs = np.array([_read_image(os.path.join(root, f"{split}_images", f"{i}.jpg")) for i in idx])
        poses = np.array([np.loadtxt(os.path.join(root, f"{split}_pose", f"{i}.txt")) for i in idx])
        ins = np.array([np.load(os.path.join(root, f"{split}_ins", f"{i}.npz"))["ins_2d_label_id"]
                        for i in idx])
        sel = np.arange(0, len(rgbs), skip)
        return (rgbs[sel] / 255.0).astype(np.float32), poses[sel].astype(np.float32), ins[sel]

    skip_test = cfg.testskip if cfg.testskip != 0 else 1
    return scene_from_arrays(cfg, _split("train", 1), _split("test", skip_test),
                             np.loadtxt(os.path.join(basedir, intrinsics_file(cfg))),
                             load_palette(basedir))
