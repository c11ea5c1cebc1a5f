"""Replica (real capture) dataset loader (``dmnerf_tpu/data/replica.py``).

 * a fixed split: train ids range(0, 900, 5), test ids train + 2; testskip subsamples
   the test list;
 * poses from traj_w_c.txt, one flat 4x4 OpenCV camera-to-world row per frame;
 * images rgb/rgb_{i}.png, labels semantic_instance/semantic_instance_{i}.png;
 * palette ins_rgb.hdf5, ins_num = its length;
 * intrinsics with focal W/2: K = [[f, 0, (W-1)/2], [0, f, (H-1)/2], [0, 0, 1]], the
   positive convention (DM-SR's K has a negative fy and fz);
 * with ``mani_demo``, objs_info.json and the demo view poses: poses[view_id]
   repeated ``views`` times, else a spherical path at theta in linspace(-180, 180,
   views), phi -65, radius 7 (DM-SR's path runs over linspace(0, 180)).

``scene_from_arrays`` is everything after the file reads, so
``data.synthetic.build_replica_scene`` builds the same SceneData in memory. Files are
read as ``data.dmsr`` reads them (Pillow, the port's HDF5 reader).
"""

from __future__ import annotations

import json
import os

import numpy as np

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.data.dmsr import _read_image, load_palette, pose_spherical
from dmnerf_tpu_torch.data.scene import SceneData


def replica_split(total: int = 900, step: int = 5):
    train_ids = list(range(0, total, step))
    test_ids = [i + step // 2 for i in train_ids]
    return train_ids, test_ids


def read_ids(cfg: Config):
    """(train ids, test ids after testskip) of the frames the loader reads."""
    train_ids, test_ids = replica_split()
    return train_ids, list(np.array(test_ids)[np.arange(0, len(test_ids), max(cfg.testskip, 1))])


def replica_intrinsics(H: int, W: int) -> np.ndarray:
    focal = W / 2.0
    return np.array([[focal, 0, (W - 1) * 0.5], [0, focal, (H - 1) * 0.5], [0, 0, 1]], np.float32)


def scene_from_arrays(cfg: Config, traj: np.ndarray, rgbs: np.ndarray, labels: np.ndarray,
                      palette: np.ndarray, objs_info=None) -> SceneData:
    """The SceneData of a Replica scene: ``traj`` [900, 4, 4] every frame's pose,
    ``rgbs`` [M, H, W, >= 3] uint8 and ``labels`` [M, H, W] of the frames of
    ``read_ids(cfg)``, train then test; ``objs_info`` the parsed objs_info.json (read
    only with ``mani_demo``)."""
    train_ids, test_ids = read_ids(cfg)
    poses = np.concatenate([traj[train_ids], traj[test_ids]], 0).astype(np.float32)
    images = (np.asarray(rgbs) / 255.0).astype(np.float32)[..., :3]
    H, W = images.shape[1:3]

    objs = view_poses = ins_map = None
    if cfg.mani_demo:
        objs, view_id, ins_map = objs_info["objects"], objs_info["view_id"], objs_info["ins_map"]
        if view_id is not None:
            view_poses = np.repeat(poses[view_id][None], cfg.views, axis=0)
        else:
            view_poses = np.stack([pose_spherical(a, -65.0, 7.0)
                                   for a in np.linspace(-180, 180, cfg.views)], 0)

    return SceneData(
        images=images, poses=poses, H=int(H), W=int(W), K=replica_intrinsics(H, W),
        i_train=np.arange(len(train_ids)),
        i_test=np.arange(len(train_ids), len(train_ids) + len(test_ids)),
        gt_labels=np.asarray(labels).astype(np.int32), ins_rgbs=palette, ins_num=len(palette),
        objs=objs, view_poses=view_poses, ins_map=ins_map,
    )


def load_replica(cfg: Config) -> SceneData:
    basedir = cfg.datadir
    ids = [i for split in read_ids(cfg) for i in split]
    traj = np.loadtxt(os.path.join(basedir, "traj_w_c.txt"), delimiter=" ").reshape(-1, 4, 4)
    rgbs = np.array([_read_image(os.path.join(basedir, "rgb", f"rgb_{i}.png")) for i in ids])
    labels = np.array([_read_image(os.path.join(basedir, "semantic_instance",
                                                f"semantic_instance_{i}.png")) for i in ids])
    objs_info = None
    if cfg.mani_demo:
        with open(os.path.join(basedir, "objs_info.json")) as f:
            objs_info = json.load(f)
    return scene_from_arrays(cfg, traj, rgbs, labels, load_palette(basedir), objs_info)
