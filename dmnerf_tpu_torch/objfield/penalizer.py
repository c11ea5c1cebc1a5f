"""Emptiness penalizer: pushes free-space points toward the "air" channel
(``dmnerf_tpu/objfield/penalizer.py``; the reference's penalizer.py:5-62).

 * per-sample metric distances p = z * ||rays_d||; depth-centred Gaussian weight
   g = exp(-(depth_dist - p)^2 / (2 deta_w^2)) / (0.4 sqrt(2 pi)) + 1e-8;
 * before the surface (p < (depth - tol) ||d||): BCE of every channel against the air
   one-hot, weighted by 1 - g, normalised by channels x mask count;
 * at the surface (within tol): BCE of the air channel against 0, weighted by g,
   normalised by mask count;
 * depth is detached: the penalizer shapes the instance field, not the geometry.
Log arguments are clamped at 1e-8, as the JAX package does.
"""

from __future__ import annotations

import math

import torch


def emptiness_penalizer(
    raw: torch.Tensor,      # [N, S, 4 + ins_num + 1]
    z_vals: torch.Tensor,   # [N, S]
    depth: torch.Tensor,    # [N] (detached here)
    rays_d: torch.Tensor,   # [N, 3]
    tolerance: float,
    deta_w: float,
) -> torch.Tensor:
    depth = depth.detach()[..., None]
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    dists_before = (depth - tolerance) * norm
    dists_after = (depth + tolerance) * norm
    depth_dist = depth * norm
    p_dists = z_vals * norm

    delta = depth_dist - p_dists
    gauss = torch.exp(-(delta ** 2) / (2.0 * deta_w ** 2)) / (0.4 * math.sqrt(2.0 * math.pi)) + 1e-8
    gauss_air = 1.0 - gauss

    mask_before = (p_dists < dists_before).to(raw.dtype)
    mask_after = (p_dists > dists_after).to(raw.dtype)
    mask_middle = 1.0 - (mask_after + mask_before)

    pred_ins = torch.sigmoid(raw[..., 4:])
    n_ch = pred_ins.shape[-1]
    air = torch.zeros(n_ch, dtype=raw.dtype, device=raw.device)
    air[-1] = 1.0
    bce_before = -air * torch.log(torch.clamp(pred_ins, min=1e-8)) \
        - (1.0 - air) * torch.log(torch.clamp(1.0 - pred_ins, min=1e-8))
    w_before = gauss_air * mask_before
    loss_before = torch.sum(bce_before * w_before[..., None]) / (
        n_ch * torch.clamp(mask_before.sum(), min=1e-8))

    bce_middle = -torch.log(torch.clamp(1.0 - pred_ins[..., -1], min=1e-8))
    w_middle = gauss * mask_middle
    loss_middle = torch.sum(bce_middle * w_middle) / torch.clamp(mask_middle.sum(), min=1e-8)
    return loss_before + loss_middle


def ins_penalizer(raw, z_vals, depth, rays_d, tolerance: float, deta_w: float):
    """The reference's ins_penalizer (penalizer.py:58-62); depth is detached inside."""
    return emptiness_penalizer(raw, z_vals, depth, rays_d, tolerance, deta_w)
