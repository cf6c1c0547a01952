"""Offline ABC preprocessing (port of ``gcanet_tpu/data/process_abc.py``):
PCA alignment of raw ABC clouds before h5 packing.  Numpy, used when a
dataset is prepared.
"""

from __future__ import annotations

import numpy as np


def pca_align(points: np.ndarray, normals: np.ndarray | None = None):
    """Center and rotate a cloud to its principal axes; unit-cube scale.

    Returns (points_aligned, normals_aligned, transform_dict) so the
    alignment is invertible for export.
    """
    mean = points.mean(0)
    centered = points - mean
    cov = centered.T @ centered / max(len(points) - 1, 1)
    w, v = np.linalg.eigh(cov)
    rot = v[:, ::-1].T                       # principal axes first
    if np.linalg.det(rot) < 0:               # keep a right-handed frame
        rot[2] = -rot[2]
    aligned = centered @ rot.T
    scale = np.abs(aligned).max() + 1e-12
    aligned = aligned / scale
    out_normals = None
    if normals is not None:
        out_normals = normals @ rot.T
        out_normals /= np.linalg.norm(out_normals, axis=1, keepdims=True) + 1e-12
    return aligned.astype(np.float32), out_normals, {
        "mean": mean, "rot": rot, "scale": scale}


def pca_restore(points: np.ndarray, transform: dict) -> np.ndarray:
    return (points * transform["scale"]) @ transform["rot"] + transform["mean"]


def pack_h5(path: str, points, labels, normals, prim, t_param):
    """Write one ABC object in the reference's h5 schema
    (ABCDataset_new.py:57-64 keys)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"writing the ABC object {path} needs h5py, which is not "
                          f"installed") from e

    with h5py.File(path, "w") as hf:
        hf.create_dataset("points", data=points.astype(np.float32))
        hf.create_dataset("labels", data=labels.astype(np.int64))
        hf.create_dataset("normals", data=normals.astype(np.float32))
        hf.create_dataset("prim", data=prim.astype(np.int64))
        hf.create_dataset("T_param", data=t_param.astype(np.float32))
