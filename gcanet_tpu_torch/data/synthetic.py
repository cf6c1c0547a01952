"""Synthetic ABC-like clouds (copy of ``synth_object`` and ``synth_batch``
from ``gcanet_tpu/data/synthetic.py``): labelled primitive instances
(planes, spheres, cylinders, cones) as point blobs on analytic surfaces,
with normals.  The same seed gives the same cloud, and the same training
batch, as the JAX package's functions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.data.abc_dataset import collate


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-12)


def synth_object(cfg: Config, rng: np.random.RandomState,
                 inst_range: tuple = (3, 9)) -> Dict[str, np.ndarray]:
    n = cfg.num_points
    k = rng.randint(*inst_range)                # instances per object
    sizes = rng.multinomial(n, np.ones(k) / k)
    pts, nrm, tgt, igt, par = [], [], [], [], []
    for i in range(k):
        m = sizes[i]
        if m == 0:
            continue
        typ = int(rng.choice([1, 3, 4, 5]))     # plane/cone/cylinder/sphere
        center = rng.uniform(-0.4, 0.4, 3)
        p22 = np.zeros(22, np.float32)
        if typ == 1:                            # plane
            nvec = _unit(rng.randn(3))
            u = _unit(np.cross(nvec, rng.randn(3)))
            v = np.cross(nvec, u)
            uv = rng.uniform(-0.15, 0.15, (m, 2))
            p = center + uv[:, :1] * u + uv[:, 1:] * v
            normals = np.tile(nvec, (m, 1))
            p22[4:7] = nvec
            p22[7] = nvec @ center
        elif typ == 5:                          # sphere
            r = rng.uniform(0.05, 0.2)
            d = rng.randn(m, 3)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            p = center + r * d
            normals = d
            p22[0:3] = center
            p22[3] = r
        elif typ == 4:                          # cylinder
            axis = _unit(rng.randn(3))
            r = rng.uniform(0.03, 0.12)
            u = _unit(np.cross(axis, rng.randn(3)))
            v = np.cross(axis, u)
            theta = rng.uniform(0, 2 * np.pi, m)
            h = rng.uniform(-0.15, 0.15, m)
            ring = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * v
            p = center + r * ring + h[:, None] * axis
            normals = ring
            p22[8:11] = axis
            p22[11:14] = center
            p22[14] = r
        else:                                   # cone (apex at center)
            axis = _unit(rng.randn(3))
            half_angle = rng.uniform(0.3, 0.7)
            u = _unit(np.cross(axis, rng.randn(3)))
            v = np.cross(axis, u)
            theta = rng.uniform(0, 2 * np.pi, m)
            t = rng.uniform(0.05, 0.3, m)       # distance along the axis
            ring = np.cos(theta)[:, None] * u + np.sin(theta)[:, None] * v
            p = (center + t[:, None] * axis
                 + (t * np.tan(half_angle))[:, None] * ring)
            normals = (np.cos(half_angle) * ring
                       - np.sin(half_angle) * axis[None, :])
            p22[15:18] = axis
            p22[18:21] = center
            p22[21] = half_angle
        pts.append(p)
        nrm.append(normals)
        tgt.append(np.full(m, typ))
        igt.append(np.full(m, i))
        par.append(np.tile(p22, (m, 1)))

    points = np.concatenate(pts).astype(np.float32)
    normals = np.concatenate(nrm).astype(np.float32)
    t_gt = np.concatenate(tgt).astype(np.int32)
    i_gt = np.concatenate(igt).astype(np.int32)
    t_param = np.concatenate(par).astype(np.float32)

    perm = rng.permutation(len(points))
    points, normals = points[perm], normals[perm]
    t_gt, i_gt, t_param = t_gt[perm], i_gt[perm], t_param[perm]

    # small instances -> background, centroid offsets (as the real pipeline)
    inst_num = int(i_gt.max()) + 1
    pt_mean = np.full((len(points), 3), -100.0, np.float32)
    pointnum, inst_cls = [], []
    for i in range(inst_num):
        idx = np.where(i_gt == i)[0]
        pt_mean[idx] = points[idx].mean(0)
        pointnum.append(idx.size)
        inst_cls.append(int(t_gt[idx[0]]) if idx.size else 0)
    return {
        "gt_pc": points,
        "gt_normal": normals,
        "T_gt": t_gt,
        "T_param": t_param,
        "I_gt": i_gt,
        "inst_num": inst_num,
        "inst_pointnum": np.asarray(pointnum, np.int32),
        "inst_cls": np.asarray(inst_cls, np.int32),
        "pt_offset_label": pt_mean - points,
    }


def synth_clouds(cfg: Config, batch_size: int, seed: int = 0,
                 inst_range: tuple = (3, 9)):
    """``batch_size`` clouds from one seed: ``(xyz, normals)``, each
    ``[B, cfg.num_points, 3]`` float32 — the serving inputs."""
    rng = np.random.RandomState(seed)
    objs = [synth_object(cfg, rng, inst_range) for _ in range(batch_size)]
    return (np.stack([o["gt_pc"] for o in objs]),
            np.stack([o["gt_normal"] for o in objs]))


def synth_batch(cfg: Config, batch_size: int, seed: int = 0,
                inst_range: tuple = (3, 9)) -> Dict[str, np.ndarray]:
    """``batch_size`` clouds from one seed, collated into a training batch
    (``data/abc_dataset.py::collate``)."""
    rng = np.random.RandomState(seed)
    return collate([synth_object(cfg, rng, inst_range)
                    for _ in range(batch_size)], cfg)
