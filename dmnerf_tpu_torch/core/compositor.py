"""Volume-rendering compositor (``dmnerf_tpu/core/compositor.py``).

  dists   = diff(z_vals) with 1e10 appended, scaled by ||rays_d||
  alpha   = 1 - exp(-relu(sigma) * dists)
  weights = alpha * exclusive_cumprod(1 - alpha + 1e-10)
  rgb_map = sum(w * sigmoid(raw_rgb));  depth_map = sum(w * z)
  ins_map = sigmoid(sum(detach(w) * ins_logits))[..., :-1]   (air channel dropped)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Composited(NamedTuple):
    rgb: torch.Tensor      # [N, 3]
    weights: torch.Tensor  # [N, S]
    depth: torch.Tensor    # [N]
    ins: torch.Tensor      # [N, ins_num] (or ins_num+1 when keep_air)


def exclusive_cumprod_one_minus(alpha: torch.Tensor, use_log_scan: bool = True) -> torch.Tensor:
    """T_i = prod_{k<i} (1 - alpha_k + 1e-10), T_0 = 1.

    The log-scan clamps 1-alpha at 1e-10 instead of adding it: in f32
    ``1 - alpha + 1e-10`` is ``1 - alpha``, exactly 0 at saturated alpha, and
    log(0) = -inf would make a backward pass emit 0*inf = NaN."""
    if use_log_scan:
        t = torch.exp(torch.cumsum(torch.log(torch.clamp(1.0 - alpha, min=1e-10)), dim=-1))
    else:
        t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    return torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], dim=-1)


def _weights(raw, z_vals, rays_d, use_log_scan=True):
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    return alpha * exclusive_cumprod_one_minus(alpha, use_log_scan)


def composite_geometry(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                       use_log_scan: bool = True):
    """(weights [N, S], rgb_map [N, 3], depth_map [N]): ``composite`` without the
    instance map, which a training step takes from ``kernels.instance_terms``."""
    weights = _weights(raw, z_vals, rays_d, use_log_scan)
    rgb_map = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :3]), dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    return weights, rgb_map, depth_map


def composite(
    raw: torch.Tensor,      # [N, S, 4 + ins_num + 1] = [rgb, sigma, ins_logits]
    z_vals: torch.Tensor,   # [N, S]
    rays_d: torch.Tensor,   # [N, 3]
    keep_air: bool = False,
    detach_ins_weights: bool = True,
    use_log_scan: bool = True,
) -> Composited:
    weights, rgb_map, depth_map = composite_geometry(raw, z_vals, rays_d, use_log_scan)
    w_ins = weights.detach() if detach_ins_weights else weights
    ins_map = torch.sigmoid(torch.sum(w_ins[..., None] * raw[..., 4:], dim=-2))
    if not keep_air:
        ins_map = ins_map[..., :-1]
    return Composited(rgb=rgb_map, weights=weights, depth=depth_map, ins=ins_map)


def composite_maps(raw, z_vals, rays_d, keep_air: bool = False):
    """Forward-only: ONE weighted reduction over the channel concat
    ``[sigmoid(rgb) | z | ins_logits]`` instead of three. The per-channel math is
    composite()'s; the single reduction drops the ins-weight detach, so the
    results are detached rather than let instance gradients reach the geometry.

    Returns (rgb [N,3], ins [N, C(-1 if not keep_air)], depth [N])."""
    w = _weights(raw, z_vals, rays_d)
    vals = torch.cat([torch.sigmoid(raw[..., :3]), z_vals[..., None], raw[..., 4:]], dim=-1)
    acc = torch.sum(vals * w[..., None], dim=-2)
    ins = torch.sigmoid(acc[..., 4:])
    if not keep_air:
        ins = ins[..., :-1]
    return acc[..., :3].detach(), ins.detach(), acc[..., 3].detach()
