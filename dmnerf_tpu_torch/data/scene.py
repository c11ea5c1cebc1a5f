"""In-memory scene container (``dmnerf_tpu/data/scene.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from dmnerf_tpu_torch.configs import Config


@dataclasses.dataclass
class SceneData:
    images: np.ndarray            # [M, H, W, 3] float32 in [0, 1]
    poses: np.ndarray             # [M, 4, 4] c2w
    H: int
    W: int
    K: np.ndarray                 # [3, 3] intrinsics (dataset-specific conventions)
    i_train: np.ndarray
    i_test: np.ndarray
    gt_labels: np.ndarray         # [M, H, W] int instance labels
    ins_rgbs: np.ndarray          # [ins_num, 3] palette
    ins_num: int
    # manipulation-demo extras (DM-SR objs_info.json)
    objs: Optional[List[Dict[str, Any]]] = None
    view_poses: Optional[np.ndarray] = None
    ins_map: Optional[Dict[str, int]] = None
    # ScanNet extras
    ins_indices: Optional[List[np.ndarray]] = None
    crop_mask: Optional[np.ndarray] = None

    @property
    def hwk(self):
        return self.H, self.W, self.K


def load_scene(cfg: Config) -> SceneData:
    if cfg.dataset_type == "dmsr":
        from dmnerf_tpu_torch.data.dmsr import load_dmsr

        return load_dmsr(cfg)
    if cfg.dataset_type == "replica":
        from dmnerf_tpu_torch.data.replica import load_replica

        return load_replica(cfg)
    if cfg.dataset_type == "scannet":
        from dmnerf_tpu_torch.data.scannet import load_scannet

        return load_scannet(cfg)
    raise ValueError(f"unknown dataset_type {cfg.dataset_type!r}")
