"""Pinhole ray generation (``dmnerf_tpu/core/rays.py``).

``rays_from_K``: dirs = [(i - cx)/fx, (j - cy)/fy, K22] rotated by c2w[:3,:3], origins
from c2w[:3,3]. DM-SR's K has negative fy and K22 = -1, so the same code serves the
blender and OpenCV conventions.
"""

from __future__ import annotations

import torch


def _dirs_from_K(px_x: torch.Tensor, px_y: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """px_x = column index i, px_y = row index j (pixel centers, float)."""
    return torch.stack(
        [(px_x - K[0, 2]) / K[0, 0], (px_y - K[1, 2]) / K[1, 1], K[2, 2] * torch.ones_like(px_x)],
        dim=-1,
    )


def rays_from_K(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Full-image rays: returns (rays_o, rays_d), each [H, W, 3]."""
    j, i = torch.meshgrid(torch.arange(H, dtype=K.dtype, device=K.device),
                          torch.arange(W, dtype=K.dtype, device=K.device), indexing="ij")
    dirs = _dirs_from_K(i, j, K)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def rays_for_pixels(px_y: torch.Tensor, px_x: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor):
    """Rays for a flat list of pixel (row=px_y, col=px_x) coords: each [N, 3]."""
    dirs = _dirs_from_K(px_x.to(K.dtype), px_y.to(K.dtype), K)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def rays_from_focal(H: int, W: int, focal: float, c2w: torch.Tensor):
    """Reference get_rays: centered at (W-1)/2, (H-1)/2, +z forward."""
    K = torch.tensor([[focal, 0.0, (W - 1) * 0.5], [0.0, focal, (H - 1) * 0.5], [0.0, 0.0, 1.0]],
                     dtype=c2w.dtype, device=c2w.device)
    return rays_from_K(H, W, K, c2w)
