"""DM-SR manipulated-ground-truth loader (``dmnerf_tpu/data/dmsr_mani.py``).

 * indoor_{mani_mode}_test/{rgbs, semantic_instance} images, poses from the scene's
   top-level transforms.json, testskip applied to both;
 * the DM-SR loader's K convention (negative fy, fz = -1);
 * ``load_mani_poses`` / ``load_obj_poses`` read the transformation_matrix.json that
   ``tools.pose_gen`` writes (eval and demo layouts).

Files are read as ``data.dmsr`` reads them; ``data.synthetic.build_dmsr_mani_scene``
builds the same SceneData in memory.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.data.dmsr import _read_image, _sorted_files, dmsr_intrinsics, load_palette
from dmnerf_tpu_torch.data.scene import SceneData


def load_dmsr_mani(cfg: Config) -> SceneData:
    basedir = cfg.datadir
    skip = cfg.testskip if cfg.testskip != 0 else 1
    root = os.path.join(basedir, f"indoor_{cfg.mani_mode}_test")

    rgbs = [_read_image(f) for f in _sorted_files(os.path.join(root, "rgbs"))]
    with open(os.path.join(basedir, "transforms.json")) as f:
        meta = json.load(f)
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"]], np.float32)[::skip]
    idx = np.arange(0, len(rgbs), skip)
    images = (np.array(rgbs)[idx] / 255.0).astype(np.float32)[..., :3]
    labels = np.array([_read_image(f)
                       for f in _sorted_files(os.path.join(root, "semantic_instance"))])[idx]

    ins_rgbs = load_palette(basedir)
    H, W = images.shape[1:3]
    n = len(images)
    return SceneData(
        images=images, poses=poses.reshape(-1, 4, 4), H=int(H), W=int(W),
        K=dmsr_intrinsics(H, W, meta["camera_angle_x"]),
        i_train=np.arange(0), i_test=np.arange(n),
        gt_labels=labels.astype(np.int32), ins_rgbs=ins_rgbs, ins_num=len(ins_rgbs),
    )


def load_mani_poses(datadir: str):
    """Eval-mode transformation_matrix.json -> list of {'transformation', 'mode'}."""
    with open(os.path.join(datadir, "transformation_matrix.json")) as f:
        return json.load(f)["transformations"]


def load_obj_poses(datadir: str):
    """Demo-mode transformation_matrix.json -> {obj_name: [pose_dict, ...]}."""
    with open(os.path.join(datadir, "transformation_matrix.json")) as f:
        return json.load(f)
