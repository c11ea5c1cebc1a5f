"""Manipulation pose generation (``dmnerf_tpu/tools/pose_gen.py``): writes
``transformation_matrix.json``.

 * ``generate_poses_eval``: per-scene object centers; center-relative translation
   (-0.25 y) / rotation (90° yaw) / scale (1.2) / multi (scale @ rot @ trans) 4x4s as
   T_inv @ M @ T; one entry for the configured mode in a {'transformations': [...]}
   dict.
 * ``generate_poses_demo``: a per-object series over ``views`` frames: translation
   accumulates distance / views per frame, rotation sweeps yaw over linspace(0, 180,
   views), scale / multi emit one entry; deform objects are skipped (they are ray
   warps at render time, ``render.manipulator.deform_ray_offsets``).
``eval_poses`` and ``demo_poses`` compute the same dicts without writing them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from dmnerf_tpu_torch.configs import Config

# per-scene manipulation centers of the DM-SR scenes
MANI_CENTERS = {
    "bathroom": [0.779178, 1.05247, 0.380208],
    "bedroom": [-1.29552, 1.72703, 0.2946],
    "dinning": [-0.633653, 0.295162, 0.279743],
    "kitchen": [-2.52579, -0.103821, 1.47165],
    "reception": [0.579352, -0.099242, 0.092597],
    "restroom": [-0.001277, -2.85079, 0.588084],
    "office": [-0.717374, 0.929292, 0.904515],
    "study": [-0.519422, -2.16509, 1.07392],
}


def r_x(roll):
    c, s = np.cos(roll), np.sin(roll)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])


def r_y(pitch):
    c, s = np.cos(pitch), np.sin(pitch)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])


def r_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def _center_frames(center: np.ndarray):
    t = np.eye(4, dtype=np.float32)
    t[:3, -1] = -np.asarray(center)
    t_inv = np.eye(4, dtype=np.float32)
    t_inv[:3, -1] = np.asarray(center)
    return t, t_inv


def _mode_matrix(mode: str) -> np.ndarray:
    if mode == "translation":
        m = np.eye(4)
        m[1, 3] = -0.25
    elif mode == "rotation":
        m = r_z(90 * np.pi / 180) @ r_y(0.0) @ r_x(0.0)
    elif mode == "scale":
        m = np.diag([1.2, 1.2, 1.2, 1.0])
    elif mode == "multi":
        s = np.diag([1.2, 1.2, 1.2, 1.0])
        r = r_z(90 * np.pi / 180)
        t = np.eye(4)
        t[1, 3] = -0.25
        m = (s @ r) @ t
    else:
        raise ValueError(f"unknown mani_mode {mode!r}")
    return m


def _write(datadir: str, out) -> None:
    with open(os.path.join(datadir, "transformation_matrix.json"), "w") as f:
        json.dump(out, f, ensure_ascii=False, indent=2)


def eval_poses(cfg: Config, center: Optional[List[float]] = None) -> Dict:
    """{'transformations': [{'transformation', 'mode'}]} for cfg.mani_mode, about the
    scene's center (MANI_CENTERS by cfg.expname, else the origin)."""
    if center is None:
        center = MANI_CENTERS.get(cfg.expname, [0.0, 0.0, 0.0])
    t, t_inv = _center_frames(np.asarray(center))
    tar = t_inv @ _mode_matrix(cfg.mani_mode) @ t
    return {"transformations": [{"transformation": tar.tolist(), "mode": cfg.mani_mode}]}


def generate_poses_eval(cfg: Config, center: Optional[List[float]] = None) -> Dict:
    """Writes {datadir}/transformation_matrix.json for the configured mani_mode."""
    out = eval_poses(cfg, center)
    _write(cfg.datadir, out)
    return out


def demo_poses(objs: List[Dict], views: int) -> Dict:
    """{obj_name: [{'transformation', 'mode'}, ...]} for every rigid object."""
    outputs = {}
    for obj in objs:
        mode = obj["mani_mode"]
        if mode == "deform":
            continue
        t, t_inv = _center_frames(np.asarray(obj["obj_center"]))
        poses_list = []
        if mode == "translation":
            for oper_dist in obj["distance"]:
                step = np.eye(4)
                step[0, 3] = oper_dist / views
                m = np.eye(4)
                for i in range(views):
                    if i > 0:
                        m = m @ step
                    tar = t_inv @ m @ t
                    poses_list.append({"transformation": tar.tolist(), "mode": mode})
        elif mode == "rotation":
            for deg in np.linspace(0, 180, views):
                r = r_z(deg * np.pi / 180) @ r_y(0.0) @ r_x(0.0)
                tar = t_inv @ r @ t
                poses_list.append({"transformation": tar.tolist(), "mode": mode})
        else:  # scale / multi: a single entry
            tar = t_inv @ _mode_matrix(mode) @ t
            poses_list.append({"transformation": tar.tolist(), "mode": mode})
        outputs[obj["obj_name"]] = poses_list
    return outputs


def generate_poses_demo(objs: List[Dict], cfg: Config) -> Dict:
    """Writes the per-object series of ``demo_poses`` for cfg.views frames."""
    out = demo_poses(objs, cfg.views)
    _write(cfg.datadir, out)
    return out
