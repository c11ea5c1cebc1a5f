"""Training-batch samplers (``dmnerf_tpu/data/samplers.py``).

``make_full_sampler`` is the reference's get_select_full (helpers.py:99-111): one
random train image per step, N_train pixels chosen uniformly without replacement,
rays computed only for the chosen pixels (``core.rays.rays_for_pixels``), rgb and
instance targets gathered. The scene lives on the device once; a step moves
nothing from the host. The image index and the pixel ids can be injected, so a test
can give this package and the JAX one the same draws.

``make_crop_sampler`` is the reference's get_select_crop (helpers.py:64-96) as the
JAX package has it (samplers.py:60-121): N_ins = int(0.3 N_train) rays from the
image's weakly labelled pixels form the batch suffix, the rest are drawn without
replacement from the centre crop. The labelled ids of every train image sit in a
padded [T, L] table on the device; the labelled rays are the top N_ins of uniform
scores over the image's valid slots (invalid slots sunk by -1e9), so an image with
fewer than N_ins labelled pixels fills the suffix with padded slots, which
``Batch.target_valid`` marks. The image slot, the labelled slots and the rgb pixel ids
can be injected.
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


def make_crop_sampler(images, labels, poses, K, i_train, n_train: int, ins_indices, crop_mask,
                      device=None):
    """ScanNet's crop + label-balanced sampler. ``ins_indices``: per train image, its
    flat labelled pixel ids; ``crop_mask`` [H, W] 0/1. Returns ``(sample, N_ins)``:
    ``sample(generator=None, t=None, lab_slots=None, rgb_ids=None) -> Batch`` on
    ``device``, where ``t`` (a slot of i_train), ``lab_slots`` ([N_ins] distinct
    columns of the labelled-id table) and ``rgb_ids`` ([N_train - N_ins] distinct flat
    pixel ids inside the crop) replace the draws from ``generator`` when given."""
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    i_train = torch.as_tensor(np.asarray(i_train), dtype=torch.long)
    W = images.shape[2]

    n_ins = int(n_train * 0.3)
    n_rgb = n_train - n_ins
    # L >= n_ins, so the top n_ins exist even when every image is under-labelled
    L = max(max(len(ix) for ix in ins_indices), n_ins)
    table = np.zeros((len(ins_indices), L), np.int64)
    counts = np.zeros((len(ins_indices),), np.int64)
    for i, ix in enumerate(ins_indices):
        table[i, :len(ix)] = ix
        counts[i] = len(ix)
    table = torch.as_tensor(table, device=device)
    crop_flat = torch.as_tensor(np.where(np.asarray(crop_mask).reshape(-1) == 1)[0],
                                dtype=torch.long, device=device)

    def sample(generator: Optional[torch.Generator] = None, t=None, lab_slots=None,
               rgb_ids=None) -> Batch:
        if t is None:
            t = torch.randint(len(i_train), (), generator=generator)
        t = int(t)
        img_i = int(i_train[t])
        if lab_slots is None:
            valid = torch.arange(L) < int(counts[t])
            scores = torch.rand(L, generator=generator) + torch.where(valid, 0.0, -1e9)
            lab_slots = torch.topk(scores, n_ins).indices
        lab_slots = torch.as_tensor(lab_slots, dtype=torch.long).to(images.device)
        if rgb_ids is None:
            rgb_ids = crop_flat[torch.randperm(len(crop_flat), generator=generator)[:n_rgb]
                                .to(images.device)]
        rgb_ids = torch.as_tensor(rgb_ids, dtype=torch.long).to(images.device)

        flat = torch.cat([rgb_ids, table[t][lab_slots]])     # labelled rays are the suffix
        py, px = flat // W, flat % W
        rays_o, rays_d = rays_for_pixels(py, px, K, poses[img_i])
        target_valid = torch.cat([torch.ones(n_rgb, dtype=torch.bool, device=images.device),
                                  lab_slots < int(counts[t])])
        return Batch(rays_o, rays_d, images[img_i][py, px], labels[img_i][py, px], target_valid)

    return sample, n_ins
