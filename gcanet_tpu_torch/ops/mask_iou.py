"""Proposal/instance mask IoU and mask labels (port of
``gcanet_tpu/ops/mask_iou.py``; reference softgroup/ops/src/
cal_iou_and_masklabel/cal_iou_and_masklabel.cu).

Entries are the fixed-shape (channel, point) pairs of ``Proposals.point_pid``;
every op is a segment count over ``pid * I + instance`` ids.  No gradient
flows through any of them.
"""

from __future__ import annotations

import torch

from gcanet_tpu_torch.ops import segment as seg


def _entries(point_pid: torch.Tensor):
    ch, n_total = point_pid.shape
    pid = point_pid.reshape(-1)
    pt = torch.arange(n_total, device=point_pid.device).repeat(ch)
    return pid, pt, pid >= 0


def _iou(pid: torch.Tensor, on: torch.Tensor, inst: torch.Tensor,
         instance_pointnum: torch.Tensor, num_proposals: int,
         num_instances: int) -> torch.Tensor:
    pair = torch.where(on & (inst >= 0) & (inst < num_instances),
                       pid * num_instances + inst, -1)
    inter = seg.segment_count(pair, num_proposals * num_instances)
    inter = inter.reshape(num_proposals, num_instances).float()
    ptotal = seg.segment_count(torch.where(on, pid, -1), num_proposals).float()
    union = ptotal[:, None] + instance_pointnum.float()[None, :] - inter
    return inter / (union + 1e-5)


@torch.no_grad()
def mask_iou_on_cluster(point_pid: torch.Tensor,        # [CH, B*N]
                        instance_labels: torch.Tensor,  # [B*N], -1 = background
                        instance_pointnum: torch.Tensor,  # [I]
                        num_proposals: int,
                        num_instances: int) -> torch.Tensor:
    """IoU of every proposal against every GT instance -> ``[P, I]``
    (cal_iou_and_masklabel.cu:9-34)."""
    pid, pt, valid = _entries(point_pid)
    return _iou(pid, valid, instance_labels[pt], instance_pointnum,
                num_proposals, num_instances)


@torch.no_grad()
def mask_iou_on_pred(point_pid: torch.Tensor,
                     instance_labels: torch.Tensor,
                     instance_pointnum: torch.Tensor,
                     mask_scores_sigmoid: torch.Tensor,  # [CH, B*N]
                     num_proposals: int,
                     num_instances: int) -> torch.Tensor:
    """IoU of the thresholded (> 0.5) predicted masks against every GT
    instance -> ``[P, I]`` (cal_iou_and_masklabel.cu:36-68)."""
    pid, pt, valid = _entries(point_pid)
    on = valid & (mask_scores_sigmoid.reshape(-1) > 0.5)
    return _iou(pid, on, instance_labels[pt], instance_pointnum,
                num_proposals, num_instances)


@torch.no_grad()
def mask_label(point_pid: torch.Tensor,
               instance_labels: torch.Tensor,
               instance_cls: torch.Tensor,      # [I], -100 = ignored class
               ious_on_cluster: torch.Tensor,   # [P, I]
               iou_thr: float) -> torch.Tensor:
    """Per-entry mask supervision -> ``[CH, B*N]`` float in {-1, 0, 1}
    (cal_iou_and_masklabel.cu:70-104): each proposal takes its best-IoU
    non-ignored instance (the first on ties); at IoU >= ``iou_thr`` its
    entries are labelled by membership of that instance, else the whole
    proposal stays ignored (-1)."""
    iou = torch.where((instance_cls != -100)[None, :], ious_on_cluster, 0.0)
    best = torch.argmax(iou, dim=1)
    best_iou = torch.gather(iou, 1, best[:, None])[:, 0]
    assign = best_iou >= iou_thr                               # [P]

    pid, pt, valid = _entries(point_pid)
    pid_c = torch.clamp(pid, 0, ious_on_cluster.shape[0] - 1).long()
    inst = instance_labels[pt]
    lbl = torch.where(assign[pid_c], (inst == best[pid_c]).float(), -1.0)
    lbl = torch.where(valid, lbl, -1.0)
    return lbl.reshape(point_pid.shape)
