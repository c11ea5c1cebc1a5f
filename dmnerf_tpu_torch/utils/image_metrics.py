"""Image quality metrics: PSNR, SSIM, LPIPS (``dmnerf_tpu/utils/image_metrics.py``).

 * ssim_np reproduces skimage.metrics.structural_similarity's defaults for float
   inputs (7x7 uniform window, K1=0.01, K2=0.03, sample covariance, channel mean,
   border-cropped mean).
 * lpips_np is the LPIPS-VGG16 distance (unit-normalized features at
   relu{1_2,2_2,3_3,4_3,5_3}, learned 1x1 weights, spatial mean, layer sum) as a
   torch forward over weights from ``$DMNERF_LPIPS_WEIGHTS`` (the .npz that
   ``tools/export_lpips_weights.py`` writes). Without the weights it returns
   NaN and says so, once, on stderr.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def psnr_np(img: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((img.astype(np.float64) - gt.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float, win_size: int) -> float:
    from scipy.ndimage import uniform_filter

    x = x.astype(np.float64)
    y = y.astype(np.float64)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1)

    def filt(a):
        return uniform_filter(a, size=win_size)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return float(S[pad:-pad or None, pad:-pad or None].mean())


def ssim_np(img: np.ndarray, gt: np.ndarray, data_range: float = 1.0, win_size: int = 7) -> float:
    """Channel-averaged SSIM."""
    if img.ndim == 3:
        return float(np.mean([_ssim_single(img[..., c], gt[..., c], data_range, win_size)
                              for c in range(img.shape[-1])]))
    return _ssim_single(img, gt, data_range, win_size)


# ---------------------------------------------------------------------------
# LPIPS (VGG16)

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_TAP_LAYERS = (1, 3, 6, 9, 12)   # conv indices of relu1_2..relu5_3
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_lpips_cache = {}
_lpips_warned = [False]


def _load_lpips_weights() -> Optional[dict]:
    path = os.environ.get("DMNERF_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    if path not in _lpips_cache:
        _lpips_cache[path] = dict(np.load(path))
    return _lpips_cache[path]


def lpips_available() -> bool:
    return _load_lpips_weights() is not None


def lpips_np(img: np.ndarray, gt: np.ndarray, device="cpu") -> float:
    """LPIPS-VGG distance between two [H, W, 3] float images in [0, 1], or NaN
    (announced once per process) when the weights are absent. Inputs go in as
    [0, 1] images through the scaling layer only, as the reference calls it."""
    weights = _load_lpips_weights()
    if weights is None:
        if not _lpips_warned[0]:
            _lpips_warned[0] = True
            print("[metrics] LPIPS: weights absent — reporting NaN. Export them on a "
                  "weights-capable host with `python -m dmnerf_tpu_torch.tools.export_lpips_weights "
                  "lpips_vgg.npz` and set $DMNERF_LPIPS_WEIGHTS (see docs/LPIPS.md).",
                  file=sys.stderr, flush=True)
        return float("nan")

    F = torch.nn.functional

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def features(x_np):
        x = tensor(x_np).permute(2, 0, 1)[None]                     # NCHW
        h = (x - tensor(_SHIFT).view(1, 3, 1, 1)) / tensor(_SCALE).view(1, 3, 1, 1)
        taps, conv_i = [], 0
        for c in _VGG_CFG:
            if c == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            w = tensor(weights[f"conv{conv_i}_w"]).permute(3, 2, 0, 1)   # HWIO -> OIHW
            h = F.relu(F.conv2d(h, w, tensor(weights[f"conv{conv_i}_b"]), padding=1))
            if conv_i in _TAP_LAYERS:
                taps.append(h)
            conv_i += 1
        return taps

    with torch.no_grad():
        total = 0.0
        for li, (a, b) in enumerate(zip(features(img), features(gt))):
            a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
            lin = tensor(weights[f"lin{li}_w"]).view(1, -1, 1, 1)
            total += float(torch.mean(torch.sum((a - b) ** 2 * lin, dim=1)))
    return float(total)
