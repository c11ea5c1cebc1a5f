"""Sphere scenes made on the device from a seed: the benchmark's own copy, in PyTorch, of
the port's analytic scene generator (``dmnerf_tpu_torch/data/synthetic.py``).

A scene is a set of coloured spheres, one instance label each, over a sky gradient,
ray-traced with the DM-SR ray convention: dirs = [(i - cx)/fx, (j - cy)/fy, K22] rotated
by the camera-to-world pose. The same function serves ScanNet's OpenCV convention, whose
K has positive fy and K22 = 1, given poses in that convention.

Everything is drawn from one ``torch.Generator`` on the scene's device in a few calls, so
one seed gives one scene, and building a 400x400 scene of 16 views takes milliseconds on
the card.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# blender <-> OpenCV camera axes
CV_FLIP = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0]))


def sphere_spec(n_objects: int, spread: float, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Centres within ``spread`` of the origin on x and y and half of it on z, radii and
    colours, all from one draw."""
    u = torch.rand((n_objects, 7), generator=gen, device=gen.device)
    centers = (u[:, :3] * 2.0 - 1.0) * torch.tensor([spread, spread, 0.5 * spread],
                                                     device=u.device)
    radii = 0.35 + 0.35 * u[:, 3]
    colors = 0.2 + 0.75 * u[:, 4:7]
    return {"centers": centers, "radii": radii, "colors": colors}


def look_at(eye: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Blender-convention camera-to-world [4, 4]: the camera looks along -z, z is up."""
    up = torch.tensor([0.0, 0.0, 1.0], device=eye.device)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    true_up = torch.linalg.cross(right, fwd)
    c2w = torch.eye(4, device=eye.device)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, eye
    return c2w


def orbit_poses(n: int, radius: float, height: float, phase: float, device) -> torch.Tensor:
    """``n`` blender-convention poses evenly on a circle around the origin, looking at it."""
    poses = []
    for t in range(n):
        ang = phase + 2.0 * math.pi * t / max(n, 1)
        eye = torch.tensor([radius * math.cos(ang), radius * math.sin(ang),
                            height + 0.3 * height * math.sin(2.0 * ang)], device=device)
        poses.append(look_at(eye, torch.zeros(3, device=device)))
    return torch.stack(poses)


def render_views(c2ws: torch.Tensor, H: int, W: int, K: torch.Tensor,
                 spec: Dict[str, torch.Tensor]):
    """(rgb [V, H, W, 3] float32 in [0, 1], label [V, H, W] int64) of each pose; label 0
    is the sky, sphere k has label k + 1. ``K`` and the poses share one convention."""
    dev = c2ws.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                        K[2, 2] * torch.ones_like(i)], -1)                     # [H, W, 3]
    rays_d = torch.einsum("hwc,vrc->vhwr", dirs, c2ws[:, :3, :3])
    rays_o = c2ws[:, None, None, :3, 3].expand_as(rays_d)
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    V = c2ws.shape[0]
    best = torch.full((V, H, W), float("inf"), device=dev)
    label = torch.zeros((V, H, W), dtype=torch.int64, device=dev)
    rgb = (0.25 + 0.35 * (d[..., 2:3] * 0.5 + 0.5)).expand(V, H, W, 3).clone()
    light = torch.tensor([0.4, -0.3, 0.85], device=dev)
    light = light / torch.linalg.norm(light)
    for k in range(spec["radii"].shape[0]):
        c, r, col = spec["centers"][k], spec["radii"][k], spec["colors"][k]
        oc = rays_o - c
        b = (oc * d).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - r * r)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc > 0) & (t > 1e-3) & (t < best)
        n = (rays_o + d * t[..., None] - c) / r
        shade = 0.35 + 0.65 * torch.clamp((n * light).sum(-1), min=0.0)
        rgb = torch.where(hit[..., None], torch.clamp(col * shade[..., None], 0.0, 1.0), rgb)
        label = torch.where(hit, k + 1, label)
        best = torch.where(hit, t, best)
    # the datasets store 8-bit images
    rgb = torch.round(rgb * 255.0) / 255.0
    return rgb, label
