"""Training losses over static shapes (port of ``gcanet_tpu/losses/losses.py``;
reference utils/loss_utils.py).

  * ``compute_embedding_loss``  (loss_utils.py:203-257)
  * ``compute_normal_loss``     (loss_utils.py:271-278)
  * ``compute_nnl_loss``        (loss_utils.py:441-455)
  * ``compute_param_loss``      (loss_utils.py:474-535)
  * ``offset_loss``             (loss_utils.py:297-306)
  * ``instance_loss``           (loss_utils.py:308-435)

Instances carry batch-global ids, as in the JAX package (its docstring
records the reference's cross-batch indexing deviation).  Every masked
reduction keeps the JAX package's form (``where`` then sum), so gradients
are zero, not NaN, at masked entries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gcanet_tpu_torch.ops import mask_iou as miou_ops
from gcanet_tpu_torch.ops import segment as seg
from gcanet_tpu_torch.ops.mathutil import safe_norm


def compute_embedding_loss(pred_feat: torch.Tensor, gt_label: torch.Tensor,
                           max_instances: int, t_pull: float = 0.5,
                           t_push: float = 1.5):
    """Pull/push embedding loss; ``pred_feat [B, N, E]``, ``gt_label [B, N]``
    with -1 background, which forms its own cluster (the reference's
    ``j - 1`` loop start, loss_utils.py:217-222).  Returns
    ``(pull + push, pull, push)``, each the mean over batch items."""
    i_max = max_instances
    eye = torch.eye(i_max, dtype=torch.bool, device=pred_feat.device)
    pulls, pushes = [], []
    for feat, lbl in zip(pred_feat, gt_label):
        sid = torch.where((lbl >= -1) & (lbl < i_max - 1), lbl + 1, i_max)
        cnt = seg.segment_count(sid, i_max)                         # [I]
        present = cnt > 0
        centers = seg.segment_mean(feat, sid, i_max)                # [I, E]
        d = safe_norm(feat - centers[torch.clamp(sid, 0, i_max - 1).long()], dim=-1)
        pull_per = seg.segment_sum(F.relu(d - t_pull), sid, i_max)
        pull_per = pull_per / torch.clamp(cnt, min=1)
        n_present = torch.clamp(present.sum(), min=1)
        pulls.append(torch.where(present, pull_per, 0.0).sum() / n_present)

        cd = safe_norm(centers[:, None, :] - centers[None, :, :], dim=-1)
        pair = present[:, None] & present[None, :] & ~eye
        push = (torch.where(pair, F.relu(t_push - cd), 0.0).sum()
                / torch.clamp(pair.sum(), min=1))
        pushes.append(torch.where(present.sum() > 1, push, 0.0))  # one center: skip
    pull_loss = torch.stack(pulls).mean()
    push_loss = torch.stack(pushes).mean()
    return pull_loss + push_loss, pull_loss, push_loss


def compute_normal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """acos of the clamped dot product, mean over all points."""
    dot = torch.clamp(torch.sum(pred * gt, dim=-1), -0.99, 0.99)
    return torch.mean(torch.arccos(dot))


def compute_nnl_loss(log_probs: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """NLL over the valid (>= 0) points."""
    k = log_probs.shape[-1]
    valid = gt >= 0
    gt_c = torch.clamp(gt, 0, k - 1).long()
    nll = -torch.gather(log_probs, -1, gt_c[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / torch.clamp(valid.sum(), min=1)


_PARAM_SLICES = {5: (0, 4), 1: (4, 8), 4: (8, 15), 3: (15, 22)}
_PARAM_TYPE_ORDER = (1, 4, 5, 3)  # iteration order at loss_utils.py:494


def compute_param_loss(pred: torch.Tensor, t_gt: torch.Tensor,
                       t_param_gt: torch.Tensor) -> torch.Tensor:
    """Per-type masked MSE with the reference's skip rules.

    Per (batch item, type): the rows of that type whose gt slice is not all
    zero, MSE over the type's parameter slice.  A group is skipped when it
    has no rows, when its full 22-d gt sums to zero, when its gt max is
    above 10 or when its loss is above 50.  The loss is the mean over the
    groups that survive.
    """
    total = pred.new_zeros(())
    cnt = pred.new_zeros(())
    for typ in _PARAM_TYPE_ORDER:                 # batched over the items
        lo, hi = _PARAM_SLICES[typ]
        in_type = t_gt == typ                                        # [B, N]
        any_rows = in_type.sum(dim=1) > 0
        gt_sum_nonzero = torch.where(in_type[..., None], t_param_gt, 0.0).sum(dim=(1, 2)) != 0
        sl_pred = pred[..., lo:hi]
        sl_gt = t_param_gt[..., lo:hi]
        row_ok = in_type & (sl_gt.sum(dim=-1) != 0)
        n_rows = row_ok.sum(dim=1)
        se = torch.where(row_ok[..., None], (sl_pred - sl_gt) ** 2, 0.0)
        mse = se.sum(dim=(1, 2)) / torch.clamp(n_rows * (hi - lo), min=1)
        gmax = torch.where(row_ok[..., None], sl_gt, float("-inf")).amax(dim=(1, 2))
        ok = any_rows & gt_sum_nonzero & (n_rows > 0) & (gmax <= 10) & (mse <= 50)
        total = total + torch.where(ok, mse, 0.0).sum()
        cnt = cnt + ok.float().sum()
    return total / torch.clamp(cnt, min=1.0)


def offset_loss(pt_offsets: torch.Tensor, instance_labels: torch.Tensor,
                pt_offset_labels: torch.Tensor) -> torch.Tensor:
    """L1 over foreground points."""
    pos = instance_labels >= 0
    cnt = pos.sum()
    l1 = torch.where(pos[:, None], torch.abs(pt_offsets - pt_offset_labels), 0.0).sum()
    return torch.where(cnt > 0, l1 / torch.clamp(cnt, min=1), 0.0)


class InstanceLossAux(NamedTuple):
    cls_loss: torch.Tensor
    mask_loss: torch.Tensor
    iou_score_loss: torch.Tensor
    num_pos: torch.Tensor
    num_neg: torch.Tensor


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[r, idx[r]]`` for every row ``r``."""
    return torch.gather(x, 1, idx.long()[:, None])[:, 0]


def instance_loss(cls_scores, mask_scores, iou_scores, point_pid, prop_valid,
                  instance_labels, instance_pointnum, instance_cls, inst_valid,
                  num_primitives: int, pos_iou_thr: float = 0.5,
                  bg_cls: int = 0):
    """SoftGroup instance loss: class CE, mask BCE and IoU-score MSE.

    ``cls_scores``/``iou_scores [P, C]``; ``mask_scores [CH, B*N, C]``
    per-entry logits; ``point_pid [CH, B*N]``; the instance tables padded
    to ``I`` rows with ``inst_valid``.  Instances of class ``bg_cls`` are
    background and proposal label ``C - 1`` is the background class.
    """
    p, c = cls_scores.shape
    i = instance_pointnum.shape[0]
    instance_classes = num_primitives - 1

    ious = miou_ops.mask_iou_on_cluster(point_pid, instance_labels,
                                        instance_pointnum, p, i)    # [P, I]

    fg = inst_valid & (instance_cls != bg_cls)
    any_fg = fg.sum() > 0
    iou_fg = torch.where(fg[None, :], ious, -1.0)
    max_iou = iou_fg.amax(dim=1)
    argmax_iou = torch.argmax(iou_fg, dim=1)
    pos = (max_iou >= pos_iou_thr) & prop_valid
    labels = torch.where(pos, instance_cls[argmax_iou], instance_classes)  # [P]

    # cls loss: CE mean over valid proposals
    ce = -_take(F.log_softmax(cls_scores, dim=-1), labels)
    n_valid = torch.clamp(prop_valid.sum(), min=1)
    cls_loss = torch.where(prop_valid, ce, 0.0).sum() / n_valid

    # mask loss: BCE of the entry's labelled-class sigmoid against mask_label
    ch, n_total, _ = mask_scores.shape
    pid_flat = point_pid.reshape(-1)
    entry_valid = pid_flat >= 0
    mask_cls = labels[torch.clamp(pid_flat, 0, p - 1).long()]           # [CH*BN]
    ms_sig = torch.sigmoid(_take(mask_scores.reshape(ch * n_total, c), mask_cls))

    inst_cls_for_label = torch.where(inst_valid, instance_cls, -100)
    mlabel = miou_ops.mask_label(point_pid, instance_labels, inst_cls_for_label,
                                 ious, pos_iou_thr).reshape(-1)
    w = (mlabel != -1.0) & entry_valid
    tgt = torch.where(mlabel == -1.0, 0.5, mlabel)
    eps = 1e-7
    bce = -(tgt * torch.log(ms_sig + eps) + (1 - tgt) * torch.log(1 - ms_sig + eps))
    mask_loss = torch.where(w, bce, 0.0).sum() / (w.sum() + 1)

    # iou score loss (loss_utils.py:409-418), on the detached mask scores
    ms_sig_entries = torch.where(entry_valid, ms_sig.detach(), 0.0).reshape(ch, n_total)
    ious_pred = miou_ops.mask_iou_on_pred(point_pid, instance_labels,
                                          instance_pointnum, ms_sig_entries, p, i)
    gt_ious = torch.where(fg[None, :], ious_pred, -1.0).amax(dim=1)
    iou_w = (labels < instance_classes) & prop_valid
    mse = (_take(iou_scores, labels) - gt_ious) ** 2
    iou_score_loss = torch.where(iou_w, mse, 0.0).sum() / (iou_w.sum() + 1)

    zero_all = ~any_fg
    cls_loss = torch.where(zero_all, 0.0, cls_loss)
    mask_loss = torch.where(zero_all, 0.0, mask_loss)
    iou_score_loss = torch.where(zero_all, 0.0, iou_score_loss)

    aux = InstanceLossAux(cls_loss, mask_loss, iou_score_loss,
                          iou_w.sum().float(), (prop_valid & ~iou_w).sum().float())
    return cls_loss + mask_loss + iou_score_loss, aux
