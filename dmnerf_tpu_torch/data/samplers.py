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

Each sampler splits into ``sample.draw(generator)``, the step's random draws on the host
as one int64 vector of ``1 + n_train`` ids (the image or its slot, then the pixel or
slot ids), and ``sample.gather(ids)``, the batch from those ids on the device with no
host read (a CUDA graph can hold it). ``sample(generator)`` is the two in turn, so a
packed run that draws ahead (``render.packing``) takes the batches of the one by one
run, bit for bit.
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
    distinct) replace the draws from ``generator`` when given. ``sample.draw`` and
    ``sample.gather`` take the ids [img_i, *pix]."""
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    i_train = torch.as_tensor(np.asarray(i_train), dtype=torch.long)
    M, H, W = images.shape[:3]
    images_flat, labels_flat = images.reshape(M, H * W, 3), labels.reshape(M, H * W)

    def draw_img(generator):
        return i_train[torch.randint(len(i_train), (), generator=generator)]

    def draw_pix(generator):
        return torch.randperm(H * W, generator=generator)[:n_train]

    def draw(generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _ids(draw_img(generator), draw_pix(generator))

    def gather(ids: torch.Tensor) -> Batch:
        img, pix = ids[:1], ids[1:]
        rays_o, rays_d = rays_for_pixels(pix // W, pix % W, K, poses.index_select(0, img)[0])
        return Batch(rays_o, rays_d, images_flat[img, pix], labels_flat[img, pix])

    def sample(generator: Optional[torch.Generator] = None, img_i=None,
               pix: Optional[torch.Tensor] = None) -> Batch:
        if img_i is None:
            img_i = draw_img(generator)
        if pix is None:
            pix = draw_pix(generator)
        return gather(_ids(img_i, pix).to(images.device))

    sample.draw, sample.gather = draw, gather
    return sample


def make_crop_sampler(images, labels, poses, K, i_train, n_train: int, ins_indices, crop_mask,
                      device=None):
    """ScanNet's crop + label-balanced sampler. ``ins_indices``: per train image, its
    flat labelled pixel ids; ``crop_mask`` [H, W] 0/1. Returns ``(sample, N_ins)``:
    ``sample(generator=None, t=None, lab_slots=None, rgb_ids=None) -> Batch`` on
    ``device``, where ``t`` (a slot of i_train), ``lab_slots`` ([N_ins] distinct
    columns of the labelled-id table) and ``rgb_ids`` ([N_train - N_ins] distinct flat
    pixel ids inside the crop) replace the draws from ``generator`` when given.
    ``sample.draw`` and ``sample.gather`` take the ids [t, *lab_slots, *rgb_ids]."""
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
    i_train = torch.as_tensor(np.asarray(i_train), dtype=torch.long)
    i_train_dev = i_train.to(images.device)
    M, H, W = images.shape[:3]
    images_flat, labels_flat = images.reshape(M, H * W, 3), labels.reshape(M, H * W)

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
    counts_dev = torch.as_tensor(counts, device=device)
    crop_flat = torch.as_tensor(np.where(np.asarray(crop_mask).reshape(-1) == 1)[0],
                                dtype=torch.long)
    rgb_valid = torch.ones(n_rgb, dtype=torch.bool, device=images.device)

    def draw_t(generator):
        return torch.randint(len(i_train), (), generator=generator)

    def draw_lab(generator, t):
        valid = torch.arange(L) < int(counts[int(t)])
        scores = torch.rand(L, generator=generator) + torch.where(valid, 0.0, -1e9)
        return torch.topk(scores, n_ins).indices

    def draw_rgb(generator):
        return crop_flat[torch.randperm(len(crop_flat), generator=generator)[:n_rgb]]

    def draw(generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = draw_t(generator)
        return _ids(t, draw_lab(generator, t), draw_rgb(generator))

    def gather(ids: torch.Tensor) -> Batch:
        t, lab_slots, rgb_ids = ids[:1], ids[1:1 + n_ins], ids[1 + n_ins:]
        img = i_train_dev[t]
        flat = torch.cat([rgb_ids, table[t, lab_slots]])     # labelled rays are the suffix
        rays_o, rays_d = rays_for_pixels(flat // W, flat % W, K, poses.index_select(0, img)[0])
        target_valid = torch.cat([rgb_valid, lab_slots < counts_dev[t]])
        return Batch(rays_o, rays_d, images_flat[img, flat], labels_flat[img, flat], target_valid)

    def sample(generator: Optional[torch.Generator] = None, t=None, lab_slots=None,
               rgb_ids=None) -> Batch:
        if t is None:
            t = draw_t(generator)
        if lab_slots is None:
            lab_slots = draw_lab(generator, t)
        if rgb_ids is None:
            rgb_ids = draw_rgb(generator)
        return gather(_ids(t, lab_slots, rgb_ids).to(images.device))

    sample.draw, sample.gather = draw, gather
    return sample, n_ins


def _ids(*parts) -> torch.Tensor:
    """The ids of one step as one int64 vector: each part (an int or a tensor) flattened."""
    return torch.cat([torch.as_tensor(p, dtype=torch.long).reshape(-1).cpu() for p in parts])
