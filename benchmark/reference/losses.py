"""DM-NeRF's training losses in plain PyTorch: the photometric MSE, the instance loss with
its optimal assignment, and the emptiness penalizer.

The assignment is solved on the host by ``scipy.optimize.linear_sum_assignment`` over
the valid rows (the instances present) against all columns; it carries no gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def mse(x, y):
    return torch.mean((x - y) ** 2)


def ins_loss(pred: torch.Tensor, labels: torch.Tensor, ins_num: int,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred [N, C] instance probabilities (air dropped), labels [N] in [0, C] (C is air,
    which no column stands for), ``mask`` [N] the rays that count. The present labels,
    in increasing order, are the rows of a one-hot target; cost[i, j] is the mean
    binary cross-entropy of column j against row i plus 1 - its soft IoU; the matched
    pairs' cross-entropy and soft IoU and the unmatched columns' mean prediction make
    the loss."""
    w = torch.ones_like(pred[:, 0]) if mask is None else mask.to(pred.dtype)
    present = torch.unique(labels[(w > 0) & (labels < ins_num)])
    gt = (labels[None, :] == present[:, None]).to(pred.dtype) * w[None, :]     # [V, N]
    n = torch.clamp(w.sum(), min=1.0)
    log_p = torch.log(torch.clamp(pred, min=1e-8))
    log_q = torch.log(torch.clamp(1.0 - pred, min=1e-8))
    ce = -(gt @ log_p + ((1.0 - gt) * w[None, :]) @ log_q) / n                  # [V, C]
    pw = pred * w[:, None]
    tp = gt @ pw
    siou = tp / (pw.sum(0)[None, :] + gt.sum(1)[:, None] - tp + 1e-6)
    cost = (ce + 1.0 - siou).detach().cpu().double().numpy()
    cost = np.nan_to_num(cost, nan=1e9, posinf=1e9, neginf=-1e9)
    rows, cols = linear_sum_assignment(cost)
    rows_t = torch.as_tensor(rows, device=pred.device)
    cols_t = torch.as_tensor(cols, device=pred.device)
    V = present.numel()
    valid_ce = ce[rows_t, cols_t].sum() / max(V, 1)
    valid_siou = (1.0 - siou[rows_t, cols_t]).sum() / max(V, 1)
    unmatched = torch.ones(pred.shape[1], dtype=torch.bool, device=pred.device)
    unmatched[cols_t] = False
    col_mean = pw.sum(0) / n
    invalid_ce = col_mean[unmatched].sum() / max(int(unmatched.sum()), 1)
    return valid_ce + invalid_ce + valid_siou


def penalizer(raw, z, depth, rays_d, tolerance: float, deta_w: float) -> torch.Tensor:
    """Samples before the surface pushed to the air channel (all channels' BCE, weighted
    by 1 - a depth-centred Gaussian), the air channel at the surface pushed to 0 (weighted
    by the Gaussian); depth detached."""
    depth = depth.detach()[..., None]
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    p = z * norm
    g = torch.exp(-((depth * norm - p) ** 2) / (2.0 * deta_w ** 2)) / (0.4 * math.sqrt(2 * math.pi))
    g = g + 1e-8
    before = (p < (depth - tolerance) * norm).to(raw.dtype)
    after = (p > (depth + tolerance) * norm).to(raw.dtype)
    middle = 1.0 - before - after
    prob = torch.sigmoid(raw[..., 4:])
    C = prob.shape[-1]
    air = torch.zeros(C, device=raw.device)
    air[-1] = 1.0
    bce = -air * torch.log(torch.clamp(prob, min=1e-8)) \
        - (1.0 - air) * torch.log(torch.clamp(1.0 - prob, min=1e-8))
    l_before = (bce * ((1.0 - g) * before)[..., None]).sum() / (C * torch.clamp(before.sum(), min=1e-8))
    l_mid = (-torch.log(torch.clamp(1.0 - prob[..., -1], min=1e-8)) * g * middle).sum() \
        / torch.clamp(middle.sum(), min=1e-8)
    return l_before + l_mid


def step_loss(out: dict, target_c, target_i, conf: dict, n_ins: Optional[int] = None,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A training step's total loss: both passes' MSE and instance loss (on the last
    ``n_ins`` rays when given, ``valid`` masking them), and the penalizer on both."""
    total = mse(out["rgb_coarse"], target_c) + mse(out["rgb_fine"], target_c)
    rows = slice(None) if n_ins is None else slice(target_i.shape[0] - n_ins, None)
    mask = None if valid is None else valid[rows]
    for which in ("coarse", "fine"):
        total = total + ins_loss(out[f"ins_{which}"][rows], target_i[rows], conf["ins_num"], mask)
    if conf["penalize"]:
        for which in ("coarse", "fine"):
            total = total + penalizer(out[f"raw_{which}"], out[f"z_{which}"],
                                      out[f"depth_{which}"], out["rays_d"],
                                      conf["tolerance"], conf["deta_w"])
    return total
