"""DM-SR (synthetic, blender-style) dataset loader (``dmnerf_tpu/data/dmsr.py``).

 * {train,test}/rgbs/*.png sorted + {split}/transforms.json (camera_angle_x and
   per-frame transform_matrix), testskip applied to the test split;
 * {split}/semantic_instance/*.png integer label maps;
 * ins_rgb.hdf5 palette ('datasets' key) -> ins_num = palette length;
 * objs_info.json: objects / view_id / ins_map for the manipulation demo;
 * K = [[f, 0, W/2], [0, -f, H/2], [0, 0, -1]] with f = 0.5 * W / tan(0.5 * angle_x),
   the negative-fy blender convention;
 * demo view poses: poses[view_id] repeated, else a spherical path.

imageio and h5py are imported inside the functions that read files, so the
in-memory scene path (data.synthetic.build_dmsr_scene) needs neither.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.data.scene import SceneData


def _read_image(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def _sorted_files(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def _rot_x(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32)


def _rot_y(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float32)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Translate z, rotate phi, rotate theta, then the blender axis flip."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    c2w = _rot_x(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_y(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def dmsr_intrinsics(H: int, W: int, angle_x: float) -> np.ndarray:
    focal = 0.5 * W / np.tan(0.5 * angle_x)
    return np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], np.float32)


def demo_view_poses(poses: np.ndarray, view_id, views: int) -> np.ndarray:
    if view_id is not None:
        return np.repeat(poses[view_id][None], views, axis=0)
    return np.stack([pose_spherical(a, -65.0, 7.0) for a in np.linspace(0, 180, views)], 0)


def _load_split(basedir: str, split: str, skip: int):
    rgbs = [_read_image(f) for f in _sorted_files(os.path.join(basedir, split, "rgbs"))]
    with open(os.path.join(basedir, split, "transforms.json")) as f:
        meta = json.load(f)
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"]], np.float32)[::skip]
    idx = np.arange(0, len(rgbs), skip)
    rgbs = (np.array(rgbs)[idx] / 255.0).astype(np.float32)[..., :3]
    ins_dir = os.path.join(basedir, split, "semantic_instance")
    labels = np.array([_read_image(f) for f in _sorted_files(ins_dir)])[idx]
    return rgbs, poses.reshape(-1, 4, 4), labels, meta["camera_angle_x"]


def load_palette(basedir: str) -> np.ndarray:
    import h5py

    with h5py.File(os.path.join(basedir, "ins_rgb.hdf5"), "r") as f:
        return f["datasets"][:]


def load_dmsr(cfg: Config) -> SceneData:
    basedir = cfg.datadir
    skip_test = cfg.testskip if cfg.testskip != 0 else 1
    train_rgbs, train_poses, train_labels, angle_x = _load_split(basedir, "train", 1)
    test_rgbs, test_poses, test_labels, _ = _load_split(basedir, "test", skip_test)

    images = np.concatenate([train_rgbs, test_rgbs], 0)
    poses = np.concatenate([train_poses, test_poses], 0)
    gt_labels = np.concatenate([train_labels, test_labels], 0)

    with open(os.path.join(basedir, "objs_info.json")) as f:
        objs_info = json.load(f)
    ins_rgbs = load_palette(basedir)
    H, W = images.shape[1:3]
    return SceneData(
        images=images, poses=poses, H=int(H), W=int(W), K=dmsr_intrinsics(H, W, angle_x),
        i_train=np.arange(len(train_rgbs)), i_test=np.arange(len(train_rgbs), len(images)),
        gt_labels=gt_labels.astype(np.int32), ins_rgbs=ins_rgbs, ins_num=len(ins_rgbs),
        objs=objs_info["objects"],
        view_poses=demo_view_poses(poses, objs_info["view_id"], cfg.views),
        ins_map=objs_info["ins_map"],
    )
