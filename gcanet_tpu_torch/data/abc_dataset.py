"""Fixed-shape batching of ABC objects (copy of ``collate`` from
``gcanet_tpu/data/abc_dataset.py``).

The h5 loader (``ABCDataset``) is not ported yet; the trainer refuses a
dataset list until it is (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from gcanet_tpu_torch.config import Config


def collate(items: List[Dict[str, np.ndarray]], cfg: Config) -> Dict[str, np.ndarray]:
    """Stack per-object arrays and pad each object's instance table to
    ``cfg.max_instances`` rows.  ``I_gt_global`` holds batch-global instance
    ids (object ``b``'s instance ``i`` is ``b * max_instances + i``; -1 is
    background or an instance beyond the table)."""
    b = len(items)
    i_max = cfg.max_instances
    batch = {
        k: np.stack([it[k] for it in items])
        for k in ("gt_pc", "gt_normal", "T_gt", "T_param", "I_gt", "pt_offset_label")
    }
    pointnum = np.zeros((b * i_max,), np.int32)
    inst_cls = np.zeros((b * i_max,), np.int32)
    inst_valid = np.zeros((b * i_max,), bool)
    i_gt_global = np.full((b, cfg.num_points), -1, np.int32)
    for bi, it in enumerate(items):
        k = min(it["inst_num"], i_max)
        pointnum[bi * i_max: bi * i_max + k] = it["inst_pointnum"][:k]
        inst_cls[bi * i_max: bi * i_max + k] = it["inst_cls"][:k]
        inst_valid[bi * i_max: bi * i_max + k] = it["inst_pointnum"][:k] > 0
        lbl = it["I_gt"]
        ok = (lbl >= 0) & (lbl < i_max)
        i_gt_global[bi][ok] = lbl[ok] + bi * i_max
    batch["instance_pointnum"] = pointnum
    batch["instance_cls"] = inst_cls
    batch["inst_valid"] = inst_valid
    batch["I_gt_global"] = i_gt_global
    return batch
