"""Scene-family instance tables and batching (copy of ``compact_instance_label``,
``instance_info`` and ``collate_scene`` from ``gcanet_tpu/data/scene_dataset.py``;
reference softgroup/data/custom.py:76-136, scannetv2.py:23-27).

The scene readers and augmentations are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gcanet_tpu_torch.config import Config


def compact_instance_label(instance_label: np.ndarray) -> np.ndarray:
    """Remap surviving instance ids to a dense 0..K-1 range; negative ids
    (ignore) pass through."""
    out = instance_label.copy()
    pos = out >= 0
    if pos.any():
        _, inv = np.unique(out[pos], return_inverse=True)
        out[pos] = inv
    return out


def instance_info(xyz: np.ndarray, instance_label: np.ndarray,
                  semantic_label: np.ndarray, max_instances: int,
                  cls_offset: int = 0) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Per-instance point counts, instance class (semantic label minus
    ``cls_offset``; -100 for classes below the offset) and per-point
    centroid offsets (-100 - xyz for points in no instance)."""
    n = xyz.shape[0]
    pt_mean = np.full((n, 3), -100.0, np.float32)
    pointnum = np.zeros((max_instances,), np.int32)
    inst_cls = np.full((max_instances,), -100, np.int32)
    inst_num = max(int(instance_label.max()) + 1, 0) if n else 0
    for i in range(min(inst_num, max_instances)):
        mask = instance_label == i
        if not mask.any():
            continue
        pt_mean[mask] = xyz[mask].mean(0)
        pointnum[i] = int(mask.sum())
        c = int(semantic_label[np.argmax(mask)])
        inst_cls[i] = c - cls_offset if c >= cls_offset else -100
    return inst_num, pointnum, inst_cls, pt_mean - xyz


def collate_scene(items: List[Dict[str, np.ndarray]], cfg: Config) -> Dict[str, np.ndarray]:
    """``[B, N, ...]`` batch plus batch-global instance tables (the layout
    of the ABC ``collate``): instance ``i`` of item ``b`` is global id
    ``b * max_instances + i``."""
    b, i_max = len(items), cfg.max_instances
    batch = {k: np.stack([it[k] for it in items])
             for k in ("xyz", "feats", "semantic", "instance", "pt_offset_label")}
    pointnum = np.zeros((b * i_max,), np.int32)
    inst_cls = np.full((b * i_max,), -100, np.int32)
    inst_valid = np.zeros((b * i_max,), bool)
    i_gt_global = np.full((b, cfg.num_points), -1, np.int32)
    for bi, it in enumerate(items):
        k = min(it["inst_num"], i_max)
        pointnum[bi * i_max: bi * i_max + k] = it["inst_pointnum"][:k]
        inst_cls[bi * i_max: bi * i_max + k] = it["inst_cls"][:k]
        inst_valid[bi * i_max: bi * i_max + k] = it["inst_pointnum"][:k] > 0
        lbl = it["instance"]
        ok = (lbl >= 0) & (lbl < i_max)
        i_gt_global[bi][ok] = lbl[ok] + bi * i_max
    batch["instance_pointnum"] = pointnum
    batch["instance_cls"] = inst_cls
    batch["inst_valid"] = inst_valid
    batch["I_gt_global"] = i_gt_global
    batch["index"] = [it["index"] for it in items]
    return batch
