"""Hungarian-matched mask criterion for the query decoder (port of
``gcanet_tpu/losses/mask2former.py``; reference models/loss.py
``HungarianMatcher`` :165-210, ``Criterion`` :212-376).

The assignment runs on the host with ``scipy.optimize.linear_sum_assignment``
on the ``Q x I`` cost (one copy to the host and one back), as the JAX
package's ``pure_callback`` does; everything else stays on the tensors'
device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Soft dice over masks: ``inputs [Q, N]`` logits, ``targets [Q, N]`` in
    {0, 1}, averaged over the ``valid`` rows."""
    probs = torch.sigmoid(inputs)
    num = 2 * (probs * targets).sum(-1)
    den = probs.sum(-1) + targets.sum(-1)
    loss = 1 - (num + 1) / (den + 1)
    return torch.where(valid, loss, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def bce_mask_loss(inputs: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    p = torch.sigmoid(inputs)
    bce = -(targets * torch.log(p + eps) + (1 - targets) * torch.log(1 - p + eps))
    return torch.where(valid, bce.mean(-1), 0.0).sum() / torch.clamp(valid.sum(), min=1)


def hungarian_match(cost: torch.Tensor, valid_rows: torch.Tensor,
                    valid_cols: torch.Tensor) -> torch.Tensor:
    """``cost [Q, I]`` -> the instance assigned to each query (-1 unmatched),
    int64 on ``cost``'s device.  Invalid rows and columns cost 1e6 and are
    never matched."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().cpu().numpy().copy()
    rows, cols = valid_rows.cpu().numpy(), valid_cols.cpu().numpy()
    c[~rows] = 1e6
    c[:, ~cols] = 1e6
    row, col = linear_sum_assignment(c)
    keep = rows[row] & cols[col]
    assign = np.full(c.shape[0], -1, np.int64)
    assign[row[keep]] = col[keep]
    return torch.as_tensor(assign, device=cost.device)


def criterion(pred: Dict, gt_masks: torch.Tensor, gt_classes: torch.Tensor,
              gt_valid: torch.Tensor, num_classes: int,
              cost_weight=(1.0, 1.0, 1.0)) -> Dict[str, torch.Tensor]:
    """One batch item: ``pred["labels"] [Q, C]``, ``pred["masks"] [Q, N]``;
    ``gt_masks [I, N]`` (float 0/1), ``gt_classes [I]``, ``gt_valid [I]``."""
    labels, masks = pred["labels"], pred["masks"]
    q, n = masks.shape
    i = gt_masks.shape[0]

    probs = torch.softmax(labels, -1)
    cls_cost = -probs[:, torch.clamp(gt_classes, 0, num_classes - 1)]   # [Q, I]
    mp = torch.sigmoid(masks)
    inter = mp @ gt_masks.T
    dice_cost = 1 - (2 * inter + 1) / (mp.sum(-1)[:, None] + gt_masks.sum(-1)[None, :] + 1)
    # BCE cost: mean over points of -gt log p - (1 - gt) log(1 - p), two matmuls
    bce_cost = ((-torch.log(mp + 1e-7)) @ gt_masks.T
                + (-torch.log(1 - mp + 1e-7)) @ (1 - gt_masks).T) / n
    cost = cost_weight[0] * cls_cost + cost_weight[1] * dice_cost + cost_weight[2] * bce_cost

    assign = hungarian_match(cost, torch.ones(q, dtype=torch.bool), gt_valid)
    matched = assign >= 0
    a = torch.clamp(assign, 0, i - 1)

    tgt_cls = torch.where(matched, gt_classes[a].long(), num_classes - 1)
    ce = -torch.log_softmax(labels, -1).gather(1, tgt_cls[:, None])[:, 0]
    cls_loss = ce.mean()

    tgt_masks = gt_masks[a]
    d = dice_loss(masks, tgt_masks, matched)
    bce = bce_mask_loss(masks, tgt_masks, matched)
    return {"cls_loss": cls_loss, "dice_loss": d, "bce_loss": bce, "loss": cls_loss + d + bce,
            "assign": assign}
