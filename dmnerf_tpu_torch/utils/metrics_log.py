"""Structured metric logging, a copy of ``dmnerf_tpu/utils/metrics_log.py``.

JSONL scalars per step window, and the reference's result files (test_results.txt
in its 9-column layout, matching_log.json) that the evaluation writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def write_test_results(
    savedir: str,
    psnrs: List[float],
    ssims: List[float],
    lpipses: List[float],
    aps: np.ndarray,  # [n_views, 6]
) -> str:
    """The reference's test_results.txt: one 9-column row per view
    (PSNR SSIM LPIPS AP@.5 .75 .8 .85 .9 .95) plus a trailing mean row."""
    aps = np.asarray(aps, np.float64)
    rows = np.stack(
        [np.asarray(psnrs), np.asarray(ssims), np.asarray(lpipses)] + [aps[:, i] for i in range(6)]
    ).T
    mean_row = np.concatenate(
        [[np.nanmean(psnrs), np.nanmean(ssims), np.nanmean(lpipses)], aps.mean(0)]
    ).reshape(1, 9)
    out = np.concatenate([rows, mean_row], 0)
    path = os.path.join(savedir, "test_results.txt")
    np.savetxt(path, out, fmt="%.6f", delimiter=" ")
    return path


def write_matching_log(savedir: str, full_map: Dict) -> str:
    """matching_log.json: per-view pred-label -> GT-label dict."""
    path = os.path.join(savedir, "matching_log.json")
    with open(path, "w") as f:
        json.dump(full_map, f)
    return path
