"""Instance-map evaluation: per-view Hungarian-matched IoU and COCO-style mAP
(``dmnerf_tpu/objfield/metrics.py``).

 * calculate_ap: sort matched IoUs by per-object confidence, threshold at
   {0.5, 0.75, 0.8, 0.85, 0.9, 0.95}, cumulative precision/recall, COCO integral AP
   (the 11-point interpolation is kept as an option).
 * ins_eval: argmax labels (optional mask -> unlabeled = ins_num, dropped), per-object
   median confidence, compacted one-hot predictions, Hungarian match against the GT
   masks, AP over the matched IoUs, and the pred->GT label mapping.

Host-side NumPy; the assignment is ``scipy.optimize.linear_sum_assignment``. Ties
may break differently from the JAX package's solver; the optimal cost is the same.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

THRESHOLDS = (0.5, 0.75, 0.8, 0.85, 0.9, 0.95)


def _lsa_rect(cost: np.ndarray) -> np.ndarray:
    """Optimal assignment for a rectangular (rows <= cols) cost matrix: the column
    of each row."""
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(cost)
    col4row = np.empty(cost.shape[0], np.int64)
    col4row[rows] = cols
    return col4row


def _pairwise_costs_np(pred_ins: np.ndarray, gt_ins: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = pred_ins.shape[0]
    log_p = np.log(pred_ins + 1e-8)
    log_1p = np.log(1.0 - pred_ins + 1e-8)
    gt_t = gt_ins.T
    cost_ce = -(gt_t @ log_p + (1.0 - gt_t) @ log_1p) / n
    tp = gt_t @ pred_ins
    pred_sum = pred_ins.sum(axis=0)[None, :]
    gt_sum = gt_ins.sum(axis=0)[:, None]
    siou = tp / (tp + (pred_sum - tp) + (gt_sum - tp) + 1e-6)
    return cost_ce, 1.0 - siou


def calculate_ap(
    ious: np.ndarray,
    gt_number: int,
    confidence: Optional[np.ndarray] = None,
    function_select: str = "integral",
) -> List[float]:
    if confidence is not None:
        order = np.argsort(-confidence, kind="stable")
        vals = ious[order]
    else:
        vals = np.sort(ious)[::-1]

    ap_list = []
    for thre in THRESHOLDS:
        tp = (vals > thre).astype(np.float64)
        cum = np.cumsum(tp)
        precisions = cum / (np.arange(len(tp)) + 1)
        recalls = cum / gt_number
        if function_select == "integral":
            mrec = np.concatenate([[0.0], recalls, [1.0]])
            mprec = np.concatenate([[0.0], precisions, [0.0]])
            for i in range(len(mprec) - 1, 0, -1):
                mprec[i - 1] = max(mprec[i - 1], mprec[i])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mprec[idx + 1]))
        else:
            ap = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                sel = recalls >= t
                p = float(np.max(precisions[sel])) if sel.any() else 0.0
                ap += p / 11.0
        ap_list.append(ap)
    return ap_list


def ins_eval(
    pred_ins: np.ndarray,   # [H, W, ins_num] composited instance probabilities
    gt_ins: np.ndarray,     # [H, W, ins_num] compacted GT one-hot masks
    gt_ins_num: int,
    ins_num: int,
    mask: Optional[np.ndarray] = None,
):
    """Returns (pred_label [H, W], ap[6], matched_gt_labels [gt_ins_num])."""
    pred_label = np.argmax(pred_ins, axis=-1)
    if mask is not None:
        pred_label = pred_label.copy()
        pred_label[mask == 0] = ins_num
        valid_pred_labels = np.unique(pred_label)[:-1]
    else:
        valid_pred_labels = np.unique(pred_label)
    valid_pred_num = len(valid_pred_labels)

    pred_conf_mask = np.max(pred_ins, axis=-1)
    pred_conf_scores = np.array(
        [np.median(pred_conf_mask[pred_label == label]) for label in valid_pred_labels],
        dtype=np.float64,
    )

    flat_label = pred_label.reshape(-1)
    pred_onehot = np.zeros((flat_label.shape[0], ins_num), np.float32)
    for j, label in enumerate(valid_pred_labels):
        pred_onehot[flat_label == label, j] = 1.0

    gt_flat = gt_ins.reshape(-1, ins_num).astype(np.float32)
    cost_ce, cost_siou = _pairwise_costs_np(pred_onehot, gt_flat)
    col4row = _lsa_rect((cost_ce + cost_siou)[:gt_ins_num])

    valid_inds = col4row.copy()
    ious = 1.0 - cost_siou[np.arange(gt_ins_num), valid_inds]

    confidence = np.zeros(gt_ins_num)
    for i, vi in enumerate(valid_inds):
        confidence[i] = pred_conf_scores[vi] if vi < valid_pred_num else 0.0

    ap = calculate_ap(ious, gt_ins_num, confidence=confidence)

    invalid = valid_inds >= valid_pred_num
    safe_inds = np.where(invalid, 0, valid_inds)
    matched = valid_pred_labels[safe_inds].astype(np.int64)
    matched[invalid] = -1
    return pred_label, ap, matched


def compact_gt_one_hot_np(gt_label: np.ndarray, ins_num: int, drop_last: bool = False):
    """GT one-hot compaction, columns ordered by ascending unique label;
    ``drop_last`` drops the unlabeled pseudo-label, which sorts last."""
    valid_labels = np.unique(gt_label)
    if drop_last:
        valid_labels = valid_labels[:-1]
    valid_num = len(valid_labels)
    flat = gt_label.reshape(-1)
    one_hot = np.zeros((flat.shape[0], ins_num), np.float32)
    for j, label in enumerate(valid_labels):
        one_hot[flat == label, j] = 1.0
    return one_hot.reshape(*gt_label.shape, ins_num), valid_num, valid_labels
