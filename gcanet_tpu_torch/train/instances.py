"""Test-time instance extraction (port of ``gcanet_tpu/train/instances.py``).

Flagship: ``merged_labels_device`` runs on the model's device and leaves only
the ``[N]`` merged labels and small ``[P, CI]`` tables to copy to the host;
``instances_from_merged`` builds the instance list there.  The host pair
``get_instances`` + ``merge_masks`` (dgcnn-4.py:1040-1120, :975-999) gives
the same labels from the fetched model outputs, and is what the device path
is held against.

Scene family: ``instance_masks_device`` keeps every kept (proposal, class)
mask on its own, overlapping (softgroup.py:537-604 never merges them);
``pack_mask_bits`` packs them eight points to a byte for the copy to the
host, ``unpack_mask_bits`` and ``instances_from_masks`` build the list there.

RLE is bit-compatible with the reference codec (softgroup/util/rle.py:5-21).
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


def get_instances(point_pid: np.ndarray,        # [CH, N]
                  semantic_scores: np.ndarray,  # [N, C] logits
                  cls_scores: np.ndarray,       # [P, C]
                  iou_scores: np.ndarray,       # [P, C]
                  mask_scores: np.ndarray,      # [CH, N, C]
                  prop_valid: np.ndarray,       # [P]
                  instance_classes: int,
                  cls_score_thr: float = 0.45,
                  mask_score_thr: float = -3.0,
                  min_npoint: int = 150) -> List[Dict]:
    """dgcnn-4.py:1040-1120 with the thresholds of :1050-1053: one RLE
    mask per kept (class, proposal), class-major, proposal-minor."""
    ch, n = point_pid.shape
    p = cls_scores.shape[0]
    if not prop_valid.any():
        return []
    e = np.exp(cls_scores - cls_scores.max(1, keepdims=True))
    cls_soft = e / e.sum(1, keepdims=True)

    instances: List[Dict] = []
    for i in range(instance_classes):
        score_pred = cls_soft[:, i] * np.clip(iou_scores[:, i], 0, 1)
        mask_pred = np.zeros((p, n), np.int32)
        for c in range(ch):
            sel = (point_pid[c] >= 0) & (mask_scores[c, :, i] > mask_score_thr)
            mask_pred[point_pid[c][sel], np.nonzero(sel)[0]] = 1
        keep = prop_valid & (cls_soft[:, i] > cls_score_thr)
        keep &= mask_pred.sum(1) >= min_npoint
        for pp in np.nonzero(keep)[0]:
            instances.append({
                "label_id": i + 1,
                "conf": float(score_pred[pp]),
                "pred_mask": rle_encode(mask_pred[pp]),
            })
    return instances


def merge_masks(instances: List[Dict]) -> np.ndarray:
    """argmax over the decoded masks -> per-point instance id
    (dgcnn-4.py:975-999); a point no mask covers lands on 0."""
    masks = np.stack([rle_decode(inst["pred_mask"]) for inst in instances])
    return masks.argmax(0).astype(np.int32)


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


@torch.no_grad()
def instance_masks_device(point_pid: torch.Tensor,     # [CH, N] int32
                          cls_scores: torch.Tensor,    # [P, C] logits
                          iou_scores: torch.Tensor,    # [P, C]
                          mask_scores: torch.Tensor,   # [CH, N, C]
                          prop_valid: torch.Tensor,    # [P] bool
                          instance_classes: int,
                          cls_score_thr: float = 0.45,
                          mask_score_thr: float = -3.0,
                          min_npoint: int = 150):
    """``get_instances`` without merging, on the device.

    Returns ``(keep [P, CI] bool, conf [P, CI] f32, npoint [P, CI] int32,
    masks [P, N, CI] bool)``; ``masks[p, :, i]`` is the union over channels
    of the entries with pid ``p`` whose class-``i`` mask score passes.
    """
    ch, n = point_pid.shape
    p = cls_scores.shape[0]
    ci = instance_classes
    dev = point_pid.device
    cls_soft = torch.softmax(cls_scores, dim=1)[:, :ci]             # [P, CI]

    passes = (point_pid >= 0)[..., None] & (mask_scores[..., :ci] > mask_score_thr)
    pid_safe = torch.where(point_pid >= 0, point_pid, p).long()     # [CH, N]
    ids = pid_safe * n + torch.arange(n, device=dev)[None, :]        # [CH, N]
    # a max over each (proposal, point) segment of the 0/1 payload, from 0:
    # an empty segment stays 0 (a max with an int32-min identity would read
    # as True after a bool cast)
    masks = torch.zeros(((p + 1) * n, ci), dtype=torch.int32, device=dev)
    masks.scatter_reduce_(0, ids.reshape(-1, 1).expand(ch * n, ci),
                          passes.reshape(ch * n, ci).to(torch.int32), "amax")
    masks = (masks[: p * n] > 0).reshape(p, n, ci)

    npoint = masks.sum(dim=1, dtype=torch.int32)                    # [P, CI]
    keep = prop_valid[:, None] & (cls_soft > cls_score_thr) & (npoint >= min_npoint)
    conf = cls_soft * torch.clamp(iou_scores[:, :ci], 0, 1)
    return keep, conf, npoint, masks


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """``[P, N, CI]`` bool -> ``[P, CI, ceil(N/8)]`` uint8, point ``8k + j``
    in bit ``j`` of byte ``k`` (little-endian bit order, so
    ``np.unpackbits(..., bitorder="little")`` inverts it)."""
    p, n, ci = masks.shape
    n8 = -(-n // 8) * 8
    m = masks.permute(0, 2, 1).to(torch.uint8)                     # [P, CI, N]
    if n8 != n:
        m = torch.nn.functional.pad(m, (0, n8 - n))
    m = m.reshape(p, ci, n8 // 8, 8)
    out = m[..., 0].clone()
    for j in range(1, 8):
        out |= m[..., j] << j
    return out


def unpack_mask_bits(bits: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_mask_bits` on the host: ``[P, CI, ceil(N/8)]``
    uint8 -> ``[P, N, CI]`` bool."""
    unpacked = np.unpackbits(bits, axis=-1, bitorder="little")[..., :n]
    return np.ascontiguousarray(unpacked.transpose(0, 2, 1)).astype(bool)


def instances_from_masks(keep: np.ndarray,         # [P, CI] bool
                         conf: np.ndarray,         # [P, CI]
                         npoint: np.ndarray,       # [P, CI]
                         masks: np.ndarray,        # [P, N, CI] bool
                         prop_mask: np.ndarray | None = None,  # [P] item filter
                         label_offset: int = 1,
                         encode_rle: bool = True) -> List[Dict]:
    """Host-side instance list from ``instance_masks_device`` outputs:
    independent, possibly overlapping masks, class-major and
    proposal-minor; each mask RLE-encoded under ``pred_mask``, or with
    ``encode_rle=False`` a dense bool array under ``mask``."""
    _, ci = keep.shape
    preds: List[Dict] = []
    for i in range(ci):
        for pp in np.nonzero(keep[:, i])[0]:
            if prop_mask is not None and not prop_mask[pp]:
                continue
            mask = masks[pp, :, i]
            preds.append({
                "label_id": i + label_offset,
                "conf": float(conf[pp, i]),
                "npoint": int(npoint[pp, i]),
                "pred_mask" if encode_rle else "mask":
                    rle_encode(mask) if encode_rle else mask,
            })
    return preds
