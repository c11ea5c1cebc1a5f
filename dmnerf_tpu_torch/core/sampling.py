"""Depth sampling along rays (``dmnerf_tpu/core/sampling.py``).

 * ``z_val_sample``:   linear near->far bins.
 * ``perturb_z_vals``: stratified jitter within midpoint bins.
 * ``sample_pdf``:     inverse-CDF sampling with the +1e-5 weight floor, a leading
                       zero in the cdf, right-searchsorted ranks, clamped gathers and
                       the denom < 1e-5 -> 1 guard.

Every function that draws randomness takes its uniforms as an optional argument
(``u``), so a test can feed this package and the JAX one the same draws; without
them it draws from the given ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch


def z_val_sample(n_rays: int, near: float, far: float, n_samples: int,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n_samples, dtype=dtype, device=device)
    z = near + t * (far - near)
    return torch.broadcast_to(z, (n_rays, n_samples))


def perturb_z_vals(z_vals: torch.Tensor, u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stratified jitter; ``u`` (shaped like z_vals) or ``generator`` supplies the draws."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if u is None:
        u = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                       device=z_vals.device)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples points from a piecewise-constant pdf.

    bins: [N, M] sorted bin positions; weights: [N, M-1] unnormalized bin mass.
    With neither ``u`` [N, n_samples] nor ``generator`` the samples are the
    deterministic linspace (the reference's det=True). Gradients are not blocked
    here; the caller detaches where the reference does."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, M]

    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if generator is None:
            u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device)
            u = torch.broadcast_to(u, shape)
        else:
            u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
