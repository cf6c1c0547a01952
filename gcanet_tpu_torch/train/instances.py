"""Test-time instance extraction (port of the serving half of
``gcanet_tpu/train/instances.py``).

``merged_labels_device`` runs on the model's device and leaves only the
``[N]`` merged labels and small ``[P, CI]`` tables to copy to the host;
``instances_from_merged`` builds the instance list there.  RLE is
bit-compatible with the reference codec (softgroup/util/rle.py:5-21).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary run-length encoding; ``counts`` is the space-joined run string."""
    m = np.concatenate([[0], mask.astype(np.uint8), [0]])
    runs = np.where(m[1:] != m[:-1])[0] + 1
    runs[1::2] -= runs[::2]
    return {"length": int(mask.size),
            "counts": " ".join(str(int(x)) for x in runs)}


def rle_decode(rle: Dict) -> np.ndarray:
    """Accepts the reference string format and the legacy list format."""
    mask = np.zeros(rle["length"], np.uint8)
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = [int(x) for x in counts.split()]
    for start, length in zip(counts[::2], counts[1::2]):
        mask[start - 1:start - 1 + length] = 1
    return mask


@torch.no_grad()
def merged_labels_device(point_pid: torch.Tensor,     # [CH, N] int32
                         cls_scores: torch.Tensor,    # [P, C] logits
                         iou_scores: torch.Tensor,    # [P, C]
                         mask_scores: torch.Tensor,   # [CH, N, C]
                         prop_valid: torch.Tensor,    # [P] bool
                         instance_classes: int,
                         cls_score_thr: float = 0.45,
                         mask_score_thr: float = -3.0,
                         min_npoint: int = 150):
    """``get_instances`` + ``merge_masks`` (dgcnn-4.py:975-999, 1040-1120)
    on the device.

    Returns ``(merged [N] int32, keep [P, CI] bool, conf [P, CI] f32,
    npoint [P, CI] int32, covered [N] bool)``.  The kept-instance order is
    ``rank = cumsum(keep.T.ravel()) - 1`` (class-major, proposal-minor);
    ``merged`` is 0 both for rank 0 and for points no kept instance covers,
    so a mask is ``(merged == rank) & covered``.
    """
    ch, n = point_pid.shape
    p = cls_scores.shape[0]
    ci = instance_classes
    dev = point_pid.device
    cls_soft = torch.softmax(cls_scores, dim=1)[:, :ci]             # [P, CI]

    passes = (point_pid >= 0)[..., None] & (mask_scores[..., :ci] > mask_score_thr)

    # distinct-point count per (proposal, class): a point counts once even
    # if several channels carry the same pid
    contrib = [passes[0]]
    for a in range(1, ch):
        earlier = torch.zeros((n, ci), dtype=torch.bool, device=dev)
        for b in range(a):
            earlier |= (point_pid[b] == point_pid[a])[:, None] & passes[b]
        contrib.append(passes[a] & ~earlier)
    contrib_arr = torch.stack(contrib)                              # [CH, N, CI]

    pid_safe = torch.where(point_pid >= 0, point_pid, p).long()     # [CH, N]
    ar_ci = torch.arange(ci, device=dev)
    ids = pid_safe[..., None] * ci + ar_ci                          # [CH, N, CI]
    npoint = torch.zeros((p + 1) * ci, dtype=torch.int32, device=dev)
    npoint.index_add_(0, ids.reshape(-1), contrib_arr.reshape(-1).to(torch.int32))
    npoint = npoint[: p * ci].reshape(p, ci)

    keep = prop_valid[:, None] & (cls_soft > cls_score_thr) & (npoint >= min_npoint)

    # merged label: minimal (class, proposal) key among kept covering masks
    keep_pad = torch.cat([keep, torch.zeros((1, ci), dtype=torch.bool, device=dev)])
    covered = passes & keep_pad[pid_safe]                           # [CH, N, CI]
    key = ar_ci * p + pid_safe[..., None]
    big = ci * (p + 1) + 1
    min_key = torch.where(covered, key, big).amin(dim=(0, 2))       # [N]

    rank = torch.cumsum(keep.t().reshape(-1).long(), dim=0) - 1     # [CI*P]
    rank = torch.cat([rank, rank.new_zeros(big - ci * p)])
    covered = min_key < ci * p
    merged = torch.where(covered, rank[torch.clamp(min_key, max=ci * p)], 0)

    conf = cls_soft * torch.clamp(iou_scores[:, :ci], 0, 1)
    return merged.to(torch.int32), keep, conf, npoint, covered


def instances_from_merged(merged: np.ndarray,      # [N] ranks (0 = also bg)
                          keep: np.ndarray,        # [P, CI] bool
                          conf: np.ndarray,        # [P, CI]
                          npoint: np.ndarray,      # [P, CI]
                          covered: np.ndarray,     # [N] bool
                          prop_mask: np.ndarray | None = None,  # [P] item filter
                          label_offset: int = 1,
                          encode_rle: bool = True) -> List[Dict]:
    """Host-side instance list from ``merged_labels_device`` outputs, in the
    class-major/proposal-minor rank order used there."""
    p, ci = keep.shape
    rank_of = -np.ones((p, ci), np.int64)
    rank_of.T[keep.T] = np.arange(int(keep.sum()))
    preds: List[Dict] = []
    for i in range(ci):
        for pp in np.nonzero(keep[:, i])[0]:
            if prop_mask is not None and not prop_mask[pp]:
                continue
            mask = (merged == rank_of[pp, i]) & covered
            preds.append({
                "label_id": i + label_offset,
                "conf": float(conf[pp, i]),
                "npoint": int(npoint[pp, i]),
                "pred_mask" if encode_rle else "mask":
                    rle_encode(mask) if encode_rle else mask,
            })
    return preds
