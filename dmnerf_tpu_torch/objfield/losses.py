"""Instance (object-field) losses and RGB metrics (``dmnerf_tpu/objfield/losses.py``).

 * img2mse / mse2psnr.
 * ins_criterion: GT labels -> compacted one-hot over the image's valid instances;
   pairwise cost = pixel-mean BCE + (1 - soft IoU); optimal row -> column matching
   (objfield.hungarian: K11 on the card, no gradient); loss = mean matched CE + mean of
   the unmatched columns' predictions + mean matched soft-IoU. Gradients flow through
   the matched cost entries only.

Every function takes a leading batch axis: ``ins_criterion`` on ``[B, N, C]``
predictions costs one assignment launch for all B matrices (the coarse and the fine one
of a training step). ``ray_mask`` [N] bool drops padded rays from every sum.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dmnerf_tpu_torch.objfield.hungarian import masked_assignment


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def compact_one_hot(gt_labels: torch.Tensor, ins_num: int,
                    ray_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape unique + one-hot compaction (``losses.py:38-58``).

    Returns (gt_ins [N, ins_num], valid_ins_num, present [ins_num] bool). Column j of
    gt_ins is the mask of the j-th smallest label present; columns >= valid are zero.
    A label outside [0, ins_num) (the air label ins_num of a crop-sampler slot that
    ``ray_mask`` pads out) marks nothing present, and its row reads the rank of the
    clamped label, as XLA's scatter drops and its gather clamps such an index."""
    gt_labels = gt_labels.long()
    idx = gt_labels.clamp(0, ins_num - 1)
    weight = (torch.ones_like(gt_labels, dtype=torch.float32) if ray_mask is None
              else ray_mask.float()) * (idx == gt_labels).float()
    present = torch.zeros(ins_num, device=gt_labels.device).scatter_reduce(
        0, idx, weight, reduce="amax") > 0
    valid = present.sum()
    rank = (torch.cumsum(present.long(), 0) - 1)[idx]
    gt_ins = torch.nn.functional.one_hot(rank.clamp(min=0), ins_num).float()
    gt_ins = gt_ins * (rank >= 0).float()[:, None]      # one_hot(-1) is a zero row
    if ray_mask is not None:
        gt_ins = gt_ins * ray_mask.float()[:, None]
    return gt_ins, valid, present


def pairwise_costs(pred_ins: torch.Tensor, gt_ins: torch.Tensor,
                   ray_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost_ce[..., i, j] = mean_n BCE(pred[..., n, j]; gt[n, i]) and
    cost_siou[..., i, j] = 1 - TP / (TP + FP + FN + 1e-6) (``losses.py:61-87``).
    Log arguments are clamped at 1e-8."""
    if ray_mask is None:
        w = None
        n = float(pred_ins.shape[-2])
    else:
        w = ray_mask.float()
        n = torch.clamp(w.sum(), min=1.0)
    log_p = torch.log(torch.clamp(pred_ins, min=1e-8))
    log_1p = torch.log(torch.clamp(1.0 - pred_ins, min=1e-8))
    gt_t = gt_ins.t()                                   # [C, N]
    not_gt_t = (1.0 - gt_t) if w is None else (1.0 - gt_t) * w[None, :]
    cost_ce = -(gt_t @ log_p + not_gt_t @ log_1p) / n
    pred_w = pred_ins if w is None else pred_ins * w[:, None]
    tp = gt_t @ pred_w                                  # [..., C, C]
    pred_sum = pred_w.sum(-2).unsqueeze(-2)
    gt_sum = gt_ins.sum(0)[:, None]
    siou = tp / (tp + (pred_sum - tp) + (gt_sum - tp) + 1e-6)
    return cost_ce, 1.0 - siou


def ins_criterion(pred_ins: torch.Tensor, gt_labels: torch.Tensor, ins_num: int,
                  ray_mask: Optional[torch.Tensor] = None):
    """pred_ins [..., N, ins_num] composited instance probabilities (air dropped);
    gt_labels [N] int labels in [0, ins_num).

    Returns (total, valid_ce, invalid_ce, valid_siou), each shaped like the leading
    axes of pred_ins (``losses.py:90-126``; the reference's evaluator.py:27-37)."""
    C = ins_num
    gt_ins, valid, _ = compact_one_hot(gt_labels, C, ray_mask)
    cost_ce, cost_siou = pairwise_costs(pred_ins, gt_ins, ray_mask)
    col4row = masked_assignment(cost_ce + cost_siou, valid)       # [..., C]

    valid_mask = (torch.arange(C, device=pred_ins.device) < valid).to(pred_ins.dtype)
    matched_ce = torch.gather(cost_ce, -1, col4row[..., None])[..., 0]
    matched_siou = torch.gather(cost_siou, -1, col4row[..., None])[..., 0]
    denom = torch.clamp(valid, min=1).to(pred_ins.dtype)
    valid_ce = (matched_ce * valid_mask).sum(-1) / denom
    valid_siou = (matched_siou * valid_mask).sum(-1) / denom

    # columns matched to a valid row; the rest are the reference's order_col[valid:]
    matched_col = torch.zeros_like(matched_ce).scatter_reduce(
        -1, col4row, valid_mask.expand_as(matched_ce), reduce="amax")
    invalid_col = 1.0 - matched_col
    n_invalid = invalid_col.sum(-1)
    if ray_mask is None:
        col_mean_pred = pred_ins.mean(-2)
    else:
        w = ray_mask.to(pred_ins.dtype)
        col_mean_pred = (pred_ins * w[:, None]).sum(-2) / torch.clamp(w.sum(), min=1.0)
    invalid_ce = (col_mean_pred * invalid_col).sum(-1) / torch.clamp(n_invalid, min=1.0)

    total = valid_ce + invalid_ce + valid_siou
    return total, valid_ce, invalid_ce, valid_siou
