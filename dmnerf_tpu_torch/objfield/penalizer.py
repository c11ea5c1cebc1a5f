"""Emptiness penalizer: pushes free-space points toward the "air" channel
(``dmnerf_tpu/objfield/penalizer.py``; the reference's penalizer.py:5-62).

 * per-sample metric distances p = z * ||rays_d||; depth-centred Gaussian weight
   g = exp(-(depth_dist - p)^2 / (2 deta_w^2)) / (0.4 sqrt(2 pi)) + 1e-8;
 * before the surface (p < (depth - tol) ||d||): BCE of every channel against the air
   one-hot, weighted by 1 - g, normalised by channels x mask count;
 * at the surface (within tol): BCE of the air channel against 0, weighted by g,
   normalised by mask count;
 * depth is detached: the penalizer shapes the instance field, not the geometry.
Log arguments are clamped at 1e-8, as the JAX package does. The loss is two ratios of
four sums over the rays (``penalizer_sums``, four a ray, then ``penalty``); with
``reduce`` the rays are sharded over a process group and the sums are summed over the
ranks before the ratios (``objfield.losses``). A training step on the card takes the
rays' sums from K12 (``kernels.instance_terms``), which computes them with the instance
map in one pass.
"""

from __future__ import annotations

import math

import torch

from dmnerf_tpu_torch.objfield.losses import Reduce, reduce_sums


def penalizer_sums(
    raw: torch.Tensor,      # [N, S, 4 + ins_num + 1]
    z_vals: torch.Tensor,   # [N, S]
    depth: torch.Tensor,    # [N] (detached here)
    rays_d: torch.Tensor,   # [N, 3]
    tolerance: float,
    deta_w: float,
) -> torch.Tensor:
    """The penalizer's four sums of each ray, [N, 4]: (sum_before, n_before, sum_middle,
    n_middle), the weighted BCE sums and the mask counts."""
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
    air = (torch.arange(n_ch, device=raw.device) == n_ch - 1).to(raw.dtype)   # one-hot, last
    bce_before = -air * torch.log(torch.clamp(pred_ins, min=1e-8)) \
        - (1.0 - air) * torch.log(torch.clamp(1.0 - pred_ins, min=1e-8))
    w_before = gauss_air * mask_before
    bce_middle = -torch.log(torch.clamp(1.0 - pred_ins[..., -1], min=1e-8))
    w_middle = gauss * mask_middle
    return torch.stack([torch.sum(bce_before * w_before[..., None], dim=(-2, -1)),
                        mask_before.sum(-1), torch.sum(bce_middle * w_middle, dim=-1),
                        mask_middle.sum(-1)], dim=-1)


def penalty(sums: torch.Tensor, n_ch: int, reduce: Reduce = None) -> torch.Tensor:
    """The penalizer's loss from the rays' ``penalizer_sums`` [N, 4] of ``n_ch`` channels
    (air included), summed over the rays and then over the ranks with ``reduce``."""
    sums = sums.sum(0)
    if reduce is not None:
        (sums,) = reduce_sums(reduce, sums)
    sum_before, n_before, sum_middle, n_middle = sums.unbind()
    return sum_before / (n_ch * torch.clamp(n_before, min=1e-8)) \
        + sum_middle / torch.clamp(n_middle, min=1e-8)


def emptiness_penalizer(raw, z_vals, depth, rays_d, tolerance: float, deta_w: float,
                        reduce: Reduce = None) -> torch.Tensor:
    """The penalizer's loss of one bundle (rays sharded over the ranks with ``reduce``)."""
    return penalty(penalizer_sums(raw, z_vals, depth, rays_d, tolerance, deta_w),
                   raw.shape[-1] - 4, reduce)


def ins_penalizer(raw, z_vals, depth, rays_d, tolerance: float, deta_w: float,
                  reduce: Reduce = None):
    """The reference's ins_penalizer (penalizer.py:58-62); depth is detached inside."""
    return emptiness_penalizer(raw, z_vals, depth, rays_d, tolerance, deta_w, reduce)
