"""Point-cloud augmentation routines (copy of ``gcanet_tpu/data/augment.py``):
the five standard PointNet augmentations the reference's
dataloader/ABCDataset_new.py:11-12,28-31 imports.  Each takes and returns a
``[B, N, 3]`` batch; without ``rng`` it draws from the global ``np.random``
stream, as ``process_object`` calls it.
"""

from __future__ import annotations

import numpy as np


def rotate_point_cloud(batch_data, rng=None):
    """Random rotation about the up (y) axis."""
    rng = rng or np.random
    out = np.empty_like(batch_data)
    for k in range(batch_data.shape[0]):
        angle = rng.uniform() * 2 * np.pi
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], batch_data.dtype)
        out[k] = batch_data[k] @ rot
    return out


def rotate_perturbation_point_cloud(batch_data, angle_sigma=0.06,
                                    angle_clip=0.18, rng=None):
    """Small random per-axis rotation perturbations."""
    rng = rng or np.random
    out = np.empty_like(batch_data)
    for k in range(batch_data.shape[0]):
        ang = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
        cx, sx = np.cos(ang[0]), np.sin(ang[0])
        cy, sy = np.cos(ang[1]), np.sin(ang[1])
        cz, sz = np.cos(ang[2]), np.sin(ang[2])
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        out[k] = batch_data[k] @ (rz @ ry @ rx).T.astype(batch_data.dtype)
    return out


def jitter_point_cloud(batch_data, sigma=0.01, clip=0.05, rng=None):
    rng = rng or np.random
    noise = np.clip(sigma * rng.randn(*batch_data.shape), -clip, clip)
    return (batch_data + noise).astype(batch_data.dtype)


def shift_point_cloud(batch_data, shift_range=0.1, rng=None):
    rng = rng or np.random
    shifts = rng.uniform(-shift_range, shift_range,
                         (batch_data.shape[0], 1, 3)).astype(batch_data.dtype)
    return batch_data + shifts


def random_scale_point_cloud(batch_data, scale_low=0.8, scale_high=1.25, rng=None):
    rng = rng or np.random
    scales = rng.uniform(scale_low, scale_high,
                         (batch_data.shape[0], 1, 1)).astype(batch_data.dtype)
    return batch_data * scales


AUGMENT_ROUTINES = (rotate_perturbation_point_cloud, jitter_point_cloud,
                    shift_point_cloud, random_scale_point_cloud,
                    rotate_point_cloud)
