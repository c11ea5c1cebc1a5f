"""NeRF sin/cos positional encoding.

Reference channel order: ``[x, sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...]``
with log-spaced frequencies ``2**linspace(0, multires-1, multires)``
(``dmnerf_tpu/core/embedding.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def embed_dim(multires: int, input_dims: int = 3) -> int:
    """Output channel count: identity + sin/cos per frequency; ``multires <= 0``
    means identity."""
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def freq_bands(multires: int) -> np.ndarray:
    return 2.0 ** np.linspace(0.0, multires - 1, multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """x: [..., d] -> [..., d*(1+2*multires)] in the reference channel order."""
    if multires <= 0:
        return x
    freqs = torch.as_tensor(freq_bands(multires), dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                       # [..., F, d]
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)    # [..., F, 2, d]
    return torch.cat([x, sc.reshape(*x.shape[:-1], -1)], dim=-1)
