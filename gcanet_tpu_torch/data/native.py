"""Per-object label preparation of the ABC loader (port of ``relabel``,
``instance_info`` and ``voxelize_idx`` from ``gcanet_tpu/data/native.py``;
the reference's dataloader/ABCDataset_new.py:82-98 and :157-178, SoftGroup's
voxelize.cpp:11-96) in vectorised numpy.

The outputs equal the JAX package's native path (``csrc/gcadata.cpp``) bit
for bit: instance ids follow the first occurrence of each kept raw label,
centroids are summed in float64 in point order and rounded once to float32,
voxels are numbered by first occurrence.
"""

from __future__ import annotations

import numpy as np


def relabel(raw_labels: np.ndarray, prim: np.ndarray, min_points: int = 100,
            fold7: bool = True):
    """Instances with ``<= min_points`` points become background (-1); the
    kept ones get compact ids in the order their raw labels first occur.
    With ``fold7`` the classes fold 10 -> 7 (7, 9 -> 6; 8 -> 2).
    Returns ``(labels [N] int32, clean_prim [N] int32)``; ``clean_prim`` is
    -1 on background."""
    raw = np.asarray(raw_labels, np.int64)
    uniq, first, inverse, counts = np.unique(raw, return_index=True,
                                             return_inverse=True, return_counts=True)
    kept = np.nonzero(counts > min_points)[0]
    ids = np.full(len(uniq), -1, np.int32)
    ids[kept[np.argsort(first[kept])]] = np.arange(len(kept), dtype=np.int32)
    labels = ids[inverse.reshape(-1)]
    out_prim = np.where(labels >= 0, np.asarray(prim, np.int64), -1)
    if fold7:
        out_prim[(out_prim == 7) | (out_prim == 9)] = 6
        out_prim[out_prim == 8] = 2
    return labels, out_prim.astype(np.int32)


def instance_info(xyz: np.ndarray, labels: np.ndarray, semantic: np.ndarray,
                  max_inst: int):
    """Per-instance statistics of instances ``0 .. max_inst - 1``.

    Returns ``(inst_num, pointnum [max_inst] int32, cls [max_inst] int32,
    offsets [N, 3] float32)``: ``inst_num`` is the largest id below
    ``max_inst`` plus one, ``cls`` the class of each instance's first point,
    ``offsets`` the instance centroid minus the point (``-100 - xyz`` for a
    point without an instance below ``max_inst``)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    labels = np.asarray(labels, np.int32)
    semantic = np.asarray(semantic, np.int32)
    ok = (labels >= 0) & (labels < max_inst)
    lbl = labels[ok].astype(np.int64)
    inst_num = int(lbl.max()) + 1 if lbl.size else 0
    count = np.bincount(lbl, minlength=max_inst)
    sums = np.stack([np.bincount(lbl, weights=xyz[ok, d].astype(np.float64),
                                 minlength=max_inst) for d in range(3)], axis=1)
    present, first = np.unique(lbl, return_index=True)
    cls = np.zeros(max_inst, np.int32)
    cls[present] = semantic[np.nonzero(ok)[0][first]]
    centroid = (sums / np.maximum(count, 1)[:, None]).astype(np.float32)
    offsets = np.float32(-100.0) - xyz
    offsets[ok] = centroid[lbl] - xyz[ok]
    return inst_num, count.astype(np.int32), cls, offsets


def voxelize_idx(coords: np.ndarray):
    """Insertion-ordered voxel dedupe: ``coords [N, 4]`` int (batch, x, y, z)
    -> ``(out_coords [V, 4] int32, p2v [N] int32, V)``, voxels numbered by
    the first point that falls in each.  The rows are compared whole, so any
    int32 coordinates are told apart."""
    coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 4)
    _, first, inverse = np.unique(coords, axis=0, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    p2v = rank[inverse.reshape(-1)].astype(np.int32)
    return coords[np.sort(first)], p2v, len(first)
