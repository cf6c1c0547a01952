"""The ABC dataset pipeline with fixed-shape batching (port of
``gcanet_tpu/data/abc_dataset.py``; the reference's
dataloader/ABCDataset_new.py):

* h5 keys points/labels/normals/prim/T_param     (:57-64)
* optional augmentation and normal noise         (:66-75)
* instances with <= 100 points -> background -1  (:82-89)
* 10 -> 7 class fold (7, 9 -> 6; 8 -> 2)         (:94-98)
* random ``num_points`` subsample                (:120-126)
* per-instance point counts, classes, centroid offsets (:157-178)

Batches pad each object's instance table to ``max_instances`` rows and
carry batch-global instance ids (``collate``).  The same seeds give the
same items as the JAX package's loader.  ``h5py`` is needed only to read
the files.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.data import native
from gcanet_tpu_torch.data.augment import AUGMENT_ROUTINES
from gcanet_tpu_torch.parallel.dist import shard_bounds


def load_h5_object(path: str) -> Dict[str, np.ndarray]:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading the ABC object {path} needs h5py, which is not "
                          f"installed; without a dataset list the trainer uses "
                          f"synthetic data") from e
    with h5py.File(path, "r") as hf:
        return {k: np.array(hf.get(k))
                for k in ("points", "labels", "normals", "prim", "T_param")}


def process_object(raw: Dict[str, np.ndarray], cfg: Config, training: bool,
                   rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """ABCDataset_new.__getitem__ (:50-152) for one object.  ``rng`` picks
    the augmentation routine, the normal noise and the subsample; the
    routine itself draws from the global ``np.random`` stream."""
    points = raw["points"].astype(np.float32)
    labels = raw["labels"].astype(np.int64)
    normals = raw["normals"].astype(np.float32)
    primitives = raw["prim"].astype(np.int64)
    t_param = raw["T_param"].astype(np.float32)

    if training and cfg.augment:
        points = AUGMENT_ROUTINES[rng.choice(5)](points[None])[0]
    if training and cfg.if_normal_noise:
        scale = 0.07
        noise = normals * np.clip(rng.randn(points.shape[0], 1) * scale,
                                  -scale, scale)
        points = (points + noise).astype(np.float32)

    label, clean_prim = native.relabel(labels, primitives, min_points=100,
                                       fold7=(cfg.num_primitives == 7))
    # background instances re-appended after the kept ones (:106-110)
    n_keep = int(label.max()) + 1 if (label >= 0).any() else 0
    i_gt_clean = np.where(label >= 0, label.astype(np.int64),
                          labels + n_keep).astype(np.int32)

    subidx = rng.choice(points.shape[0], cfg.num_points, replace=False)
    points, normals = points[subidx], normals[subidx]
    clean_prim, t_param, label = clean_prim[subidx], t_param[subidx], label[subidx]
    i_gt_clean = i_gt_clean[subidx]

    inst_num, pointnum, inst_cls, pt_offset_label = native.instance_info(
        points, label, clean_prim, cfg.max_instances)

    return {
        "gt_pc": points,
        "gt_normal": normals,
        "T_gt": clean_prim.astype(np.int32),
        "T_param": t_param,
        "I_gt": label.astype(np.int32),
        "I_gt_clean": i_gt_clean,
        "inst_num": inst_num,
        "inst_pointnum": pointnum,
        "inst_cls": inst_cls,
        "pt_offset_label": pt_offset_label,
    }


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


class ABCDataset:
    """The objects named in ``<root>/<filename>`` (one name per line, the h5
    file being ``<root>/<name>.h5``): every ``skip``-th line, the list
    repeated ``fold`` times (ABCDataset_new.py:22-48)."""

    def __init__(self, root: str, filename: str, cfg: Config,
                 skip: int = 1, fold: int = 1, training: bool = True):
        self.root = root
        self.cfg = cfg
        self.training = training
        with open(os.path.join(root, filename)) as f:
            self.data_list = [line.strip() for line in f][::skip]
        self.tru_len = len(self.data_list)
        self.len = self.tru_len * fold

    def __len__(self):
        return self.len

    def get(self, index: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        name = self.data_list[index % self.tru_len]
        raw = load_h5_object(os.path.join(self.root, name + ".h5"))
        item = process_object(raw, self.cfg, self.training, rng)
        item["index"] = name
        return item

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                shard: tuple = (0, 1),
                stride: tuple = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        """Collated batches; a last partial batch is dropped.

        ``shard=(rank, world)``: this process loads only its contiguous
        chunk of every global batch (every process seeds the same, so the
        global order agrees).  ``stride=(rank, world)``: this process takes
        batches ``rank, rank + world, ...`` (the eval split).  Each item's
        RNG is seeded from the epoch seed and its slot in the global order,
        so a process loading a chunk gets the items a single process would.
        """
        rank, world = shard
        srank, sworld = stride
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        lo, hi = shard_bounds(batch_size, rank, world)
        starts = range(0, len(order) - batch_size + 1, batch_size)
        for bi, start in enumerate(starts):
            if bi % sworld != srank:
                continue
            items = [self.get(int(i), np.random.RandomState(
                        (seed * 100003 + start + off) % (2 ** 31)))
                     for off, i in enumerate(order[start + lo:start + hi], start=lo)]
            batch = collate(items, self.cfg)
            batch["index"] = [it["index"] for it in items]
            yield batch
