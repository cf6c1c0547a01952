"""Evaluation metrics on the host (copy of ``gcanet_tpu/train/metrics.py``;
the reference's utils/loss_utils.py): Hungarian-matched segmentation mIoU
(``hungarian_matching`` :43-63 with scipy's ``linear_sum_assignment`` for
lapsolver, ``compute_riou`` :65-82, ``compute_miou`` :84-107) and the type
mIoU with the spline-class folds (``compute_type_miou_abc`` :150-201).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

DIVISION_EPS = 1e-10


def _one_hot(x: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros((x.shape[0], k), np.float32)
    ok = (x >= 0) & (x < k)
    out[np.arange(x.shape[0])[ok], x[ok]] = 1.0
    return out


def hungarian_matching(w_pred: np.ndarray, w_gt: np.ndarray):
    dot = (w_pred[:, :, None] * w_gt[:, None, :]).sum(0)
    denom = w_pred.sum(0)[:, None] + w_gt.sum(0)[None, :] - dot
    cost = dot / np.maximum(denom, DIVISION_EPS)
    row, col = linear_sum_assignment(-cost)
    return row, col


def compute_riou(w_pred, w_gt, pred_ind, gt_ind):
    wp = w_pred[:, pred_ind]
    wg = w_gt[:, gt_ind]
    dot = (wp * wg).sum(0)
    denom = wp.sum(0) + wg.sum(0) - dot
    return dot / (denom + DIVISION_EPS)


def _one_hots(cluster_pred: np.ndarray, i_gt: np.ndarray):
    one_hot_pred = _one_hot(cluster_pred, cluster_pred.max() + 1)
    if i_gt.min() == -1:
        one_hot_gt = _one_hot(i_gt + 1, i_gt.max() + 2)[:, 1:]
    else:
        one_hot_gt = _one_hot(i_gt, i_gt.max() + 1)
    return one_hot_pred, one_hot_gt


def compute_miou(cluster_pred: np.ndarray, i_gt: np.ndarray) -> float:
    """cluster_pred, i_gt: [N] int; i_gt may contain -1 background."""
    one_hot_pred, one_hot_gt = _one_hots(cluster_pred, i_gt)
    pred_ind, gt_ind = hungarian_matching(one_hot_pred, one_hot_gt)
    riou = compute_riou(one_hot_pred, one_hot_gt, pred_ind, gt_ind)
    return float(riou.sum() / max(len(riou), 1))


def _fold_types(t: np.ndarray) -> np.ndarray:
    t = t.copy()
    t[t == 6] = 0
    t[t == 7] = 0
    t[t == 9] = 0
    t[t == 8] = 2
    return t


def _mode(x: np.ndarray) -> int:
    vals, cnt = np.unique(x, return_counts=True)
    return int(vals[np.argmax(cnt)])


def compute_type_miou_abc(type_per_point: np.ndarray, t_gt: np.ndarray,
                          cluster_pred: np.ndarray, i_gt: np.ndarray) -> float:
    """type_per_point [N, K] scores (argmaxed) or [N] labels."""
    t_pred = type_per_point.argmax(-1) if type_per_point.ndim == 2 else type_per_point
    t_pred = _fold_types(t_pred)
    t_gt = _fold_types(t_gt)

    one_hot_pred, one_hot_gt = _one_hots(cluster_pred, i_gt)
    pred_ind, gt_ind = hungarian_matching(one_hot_pred, one_hot_gt)
    hit, cnt = 0, 0
    for p_ind, g_ind in zip(pred_ind, gt_ind):
        gt_pts = t_gt[i_gt == g_ind]
        pr_pts = t_pred[cluster_pred == p_ind]
        if gt_pts.size == 0 or pr_pts.size == 0:
            continue
        if _mode(gt_pts) == _mode(pr_pts):
            hit += 1
        cnt += 1
    return hit / max(cnt, 1)
