"""Label-map -> RGB visualization via the instance palette, a NumPy copy of
``dmnerf_tpu/tools/visualizer.py``:
 * render_label2img: predicted labels colored through pred->GT ins_map then the
   scene color_dict into the ins_rgb palette; unmatched labels stay black;
 * render_gt_label2img: GT labels colored through color_dict directly;
 * ins2img: direct palette coloring (label 0 = black);
 * render_label2world: the same mapping for per-vertex mesh colors;
 * show_instance_rgb: palette contact sheet (matplotlib, optional).

Each mapping is one lookup-table gather.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _build_lut(ins_rgbs: np.ndarray, n_labels: int, color_dict: Optional[Dict] = None,
               ins_map: Optional[Dict] = None) -> np.ndarray:
    """LUT[label] -> rgb. Labels are first translated pred->GT via ins_map (if given),
    then GT->palette row via color_dict (if given); untranslatable labels -> black."""
    lut = np.zeros((n_labels + 1, 3), np.uint8)
    for label in range(n_labels + 1):
        key = str(label)
        if ins_map is not None:
            if key not in ins_map:
                continue
            key = str(ins_map[key])
        if color_dict is not None:
            if key not in color_dict:
                continue
            row = color_dict[key]
        else:
            row = int(key)
        if 0 <= row < len(ins_rgbs):
            lut[label] = ins_rgbs[row]
    return lut


def render_label2img(pred_labels: np.ndarray, ins_rgbs: np.ndarray, color_dict: Dict,
                     ins_map: Dict) -> np.ndarray:
    """Predicted [H, W] labels -> uint8 RGB (reference visualizer.py:76-89)."""
    pred_labels = np.asarray(pred_labels).astype(np.int64)
    lut = _build_lut(ins_rgbs, int(pred_labels.max(initial=0)) + 1, color_dict, ins_map)
    return lut[np.clip(pred_labels, 0, len(lut) - 1)]


def render_gt_label2img(gt_labels: np.ndarray, ins_rgbs: np.ndarray, color_dict: Dict) -> np.ndarray:
    """GT [H, W] labels -> uint8 RGB (reference visualizer.py:58-72)."""
    gt_labels = np.asarray(gt_labels).astype(np.int64)
    lut = _build_lut(ins_rgbs, int(gt_labels.max(initial=0)) + 1, color_dict, None)
    return lut[np.clip(gt_labels, 0, len(lut) - 1)]


def ins2img(predicted_onehot: np.ndarray, ins_rgbs: np.ndarray) -> np.ndarray:
    """argmax one-hot -> palette colors, label 0 black (reference visualizer.py:7-19)."""
    labels = np.argmax(np.asarray(predicted_onehot), axis=-1)
    n = max(int(labels.max(initial=0)) + 1, len(ins_rgbs))
    lut = np.zeros((n, 3), np.uint8)
    m = min(n, len(ins_rgbs))
    lut[1:m] = np.asarray(ins_rgbs[1:m], np.uint8)  # label 0 stays black
    return lut[labels]


def render_label2world(pred_labels: np.ndarray, ins_rgbs: np.ndarray, color_dict: Dict,
                       ins_map: Dict) -> np.ndarray:
    """Per-point labels [N] -> RGB [N, 3] (reference visualizer.py:207-223)."""
    pred_labels = np.asarray(pred_labels).astype(np.int64)
    lut = _build_lut(ins_rgbs, int(pred_labels.max(initial=0)) + 1, color_dict, ins_map)
    return lut[np.clip(pred_labels, 0, len(lut) - 1)]


def show_instance_rgb(ins_rgbs: np.ndarray, save_path: str) -> None:
    """Palette contact sheet (reference visualizer.py:106-126); matplotlib-gated."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    n = len(ins_rgbs)
    cols = 4
    rows = max((n + cols - 1) // cols, 1)
    fig, ax = plt.subplots(rows, cols, figsize=(8, 2 * rows), squeeze=False)
    for i in range(rows * cols):
        a = ax[i // cols][i % cols]
        a.axis("off")
        if i < n:
            a.imshow(np.full((8, 8, 3), ins_rgbs[i], np.uint8))
            a.set_title(f"Label {i}: {list(ins_rgbs[i])}", fontsize=6)
    fig.savefig(save_path)
    plt.close(fig)
