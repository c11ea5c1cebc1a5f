"""Training-batch samplers (``dmnerf_tpu/data/samplers.py``).

``make_full_sampler`` is the reference's get_select_full (helpers.py:99-111): one
random train image per step, N_train pixels chosen uniformly without replacement,
rays computed only for the chosen pixels (``core.rays.rays_for_pixels``), rgb and
instance targets gathered. The scene lives on the device once; a step moves
nothing from the host. The image index and the pixel ids can be injected, so a test
can give this package and the JAX one the same draws.

ScanNet's crop sampler (``make_crop_sampler``, samplers.py:60-121) comes with the
ScanNet loader (ROADMAP.md queue 1, "Replica and ScanNet").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dmnerf_tpu_torch.core.rays import rays_for_pixels
from dmnerf_tpu_torch.render.trainstep import Batch


def make_full_sampler(images, labels, poses, K, i_train, n_train: int, device=None):
    """images [M,H,W,3], labels [M,H,W], poses [M,4,4], K [3,3], i_train [T] (numpy or
    tensors). Returns ``sample(generator=None, img_i=None, pix=None) -> Batch`` on
    ``device``: ``img_i`` (an image index) and ``pix`` ([n_train] flat pixel ids,
    distinct) replace the draws from ``generator`` when given."""
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    i_train = torch.as_tensor(np.asarray(i_train), dtype=torch.long)
    H, W = images.shape[1], images.shape[2]

    def sample(generator: Optional[torch.Generator] = None, img_i=None,
               pix: Optional[torch.Tensor] = None) -> Batch:
        if img_i is None:
            img_i = i_train[torch.randint(len(i_train), (), generator=generator)]
        img_i = int(img_i)
        if pix is None:
            pix = torch.randperm(H * W, generator=generator)[:n_train]
        pix = torch.as_tensor(pix, dtype=torch.long).to(images.device)
        py, px = pix // W, pix % W
        rays_o, rays_d = rays_for_pixels(py, px, K, poses[img_i])
        return Batch(rays_o, rays_d, images[img_i][py, px], labels[img_i][py, px])

    return sample
