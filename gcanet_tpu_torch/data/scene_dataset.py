"""Scene-level (ScanNet-style) dataset pipeline with fixed-shape batching (the
port's copy of ``gcanet_tpu/data/scene_dataset.py``; reference
softgroup/data/custom.py, scannetv2.py, s3dis.py, stpls3d.py, kitti.py).

A glob-driven scene list, elastic distortion, jitter/flip/rotate/scale
augmentation, cropping to a point budget, instance-label compaction and
per-instance centroid offsets.  Every draw comes from the
``np.random.RandomState`` handed in, in the JAX package's order, so both
packages make the same batches bit for bit (the one exception is the JAX
package's own: the S3DIS x4 training subsample draws from the global
``np.random``, and so does this copy).  Each scene is subsampled or
repeat-padded to exactly ``num_points`` and its coordinates normalised to
the unit cube of the dense scene grid.

File formats: ``.pth`` tuples ``(xyz, rgb, sem_label, inst_label)`` as the
reference's preprocessed ScanNet dumps (scannetv2.py:15-21), and ``.npz``
with keys ``xyz/rgb/semantic/instance``.
"""

from __future__ import annotations

import glob as _glob
import math
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from gcanet_tpu_torch.config import Config


def elastic(x: np.ndarray, gran: float, mag: float,
            rng: np.random.RandomState) -> np.ndarray:
    """Elastic distortion (custom.py:52-74): a trilinearly interpolated,
    smoothed noise field added to the voxel-scaled coordinates."""
    import scipy.interpolate
    import scipy.ndimage

    blurs = [np.ones((3, 1, 1), np.float32) / 3,
             np.ones((1, 3, 1), np.float32) / 3,
             np.ones((1, 1, 3), np.float32) / 3]
    bb = np.abs(x).max(0).astype(np.int32) // gran + 3
    noise = [rng.randn(bb[0], bb[1], bb[2]).astype(np.float32) for _ in range(3)]
    for _ in range(2):
        for blur in blurs:
            noise = [scipy.ndimage.convolve(n, blur, mode="constant", cval=0) for n in noise]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in bb]
    interp = [scipy.interpolate.RegularGridInterpolator(ax, n, bounds_error=False,
                                                        fill_value=0) for n in noise]
    g = np.hstack([i(x)[:, None] for i in interp])
    return x + g * mag


def data_augment(xyz: np.ndarray, jitter: bool, flip: bool, rot: bool, scale: bool,
                 prob: float, rng: np.random.RandomState) -> np.ndarray:
    """custom.py:93-112, including the reference's fixed 0.35*pi rotation on
    the no-rotation (eval) branch."""
    m = np.eye(3)
    if jitter and rng.rand() < prob:
        m = m + rng.randn(3, 3) * 0.1
    if flip and rng.rand() < prob:
        m[0][0] *= rng.randint(0, 2) * 2 - 1
    if rot and rng.rand() < prob:
        theta = rng.rand() * 2 * math.pi
    else:
        theta = 0.35 * math.pi
    m = np.matmul(m, [[math.cos(theta), math.sin(theta), 0],
                      [-math.sin(theta), math.cos(theta), 0], [0, 0, 1]])
    if scale and rng.rand() < prob:
        xyz = xyz * rng.uniform(0.95, 1.05)
    return np.matmul(xyz, m)


def crop(xyz: np.ndarray, spatial_shape: int, max_npoint: int,
         rng: np.random.RandomState, step: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """custom.py:114-127: shrink an xy window until at most ``max_npoint``
    points survive; returns the shifted points and the survivors' mask."""
    xyz_offset = xyz.copy()
    valid = xyz_offset.min(1) >= 0
    shape = np.array([spatial_shape] * 3, np.float64)
    room_range = xyz.max(0) - xyz.min(0)
    while valid.sum() > max_npoint:
        step_t = step * 2 if valid.sum() > 1e6 else step
        offset = np.clip(shape - room_range + 0.001, None, 0) * rng.rand(3)
        xyz_offset = xyz + offset
        valid = (xyz_offset.min(1) >= 0) & ((xyz_offset < shape).sum(1) == 3)
        shape[:2] -= step_t
    return xyz_offset, valid


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


def load_scene(path: str) -> Dict[str, np.ndarray]:
    """One scene file: ``.npz`` or a ``torch.save``d ``.pth`` tuple (a
    2-tuple of a test split gets zero labels)."""
    if path.endswith(".npz"):
        z = np.load(path)
        return {"xyz": z["xyz"], "rgb": z["rgb"],
                "semantic": z["semantic"], "instance": z["instance"]}
    import torch

    data = torch.load(path, weights_only=False)
    if len(data) == 2:
        xyz, rgb = data
        zeros = np.zeros(np.asarray(xyz).shape[0], np.float32)
        data = (xyz, rgb, zeros, zeros)
    xyz, rgb, sem, inst = data
    return {"xyz": np.asarray(xyz), "rgb": np.asarray(rgb),
            "semantic": np.asarray(sem), "instance": np.asarray(inst)}


class SceneDataset:
    """ScanNet-style scene dataset (softgroup/data/custom.py:14-48).

    ``voxel_scale``/``spatial_shape``/``max_npoint`` mirror the reference's
    voxel_cfg; ``cls_offset=2`` is the ScanNet instance-class shift.
    """

    def __init__(self, data_root: str, prefix, suffix: str, cfg: Config,
                 training: bool = True, with_label: bool = True,
                 repeat: int = 1, voxel_scale: float = 50.0,
                 spatial_shape: int = 512, max_npoint: int = 250000,
                 min_npoint: int = 5000, cls_offset: int = 2,
                 aug_prob: float = 1.0):
        self.cfg = cfg
        self.training = training
        self.with_label = with_label
        self.voxel_scale = voxel_scale
        self.spatial_shape = spatial_shape
        self.max_npoint = max_npoint
        self.min_npoint = min_npoint
        self.cls_offset = cls_offset
        self.aug_prob = aug_prob
        self.filenames: List[str] = \
            sorted(self.collect_filenames(data_root, prefix, suffix)) * repeat
        if not self.filenames:
            raise FileNotFoundError(f"Empty scene dataset: {data_root}/{prefix}/*{suffix}")
        self.suffix = suffix

    def collect_filenames(self, data_root, prefix, suffix) -> List[str]:
        return _glob.glob(os.path.join(data_root, prefix, "*" + suffix))

    def load(self, path: str) -> Dict[str, np.ndarray]:
        return load_scene(path)

    def __len__(self):
        return len(self.filenames)

    def _transform(self, raw: Dict[str, np.ndarray], rng: np.random.RandomState):
        """custom.py:138-168; ``None`` when no crop keeps ``min_npoint``."""
        xyz0, rgb = raw["xyz"].astype(np.float32), raw["rgb"].astype(np.float32)
        sem = raw["semantic"].astype(np.int32)
        inst = raw["instance"].astype(np.int32)
        if self.training:
            # the reference passes aug_prob into the *scale* slot positionally
            # (custom.py:139 vs :93), so all four augmentations run at 1.0
            xyz_mid = data_augment(xyz0, True, True, True, bool(self.aug_prob), 1.0,
                                   rng).astype(np.float32)
            xyz = xyz_mid * self.voxel_scale
            if rng.rand() < self.aug_prob:
                xyz = elastic(xyz, 6, 40.0, rng)
                xyz = elastic(xyz, 20, 160.0, rng)
            xyz = xyz - xyz.min(0)
            for _ in range(5):
                xyz_off, valid = crop(xyz, self.spatial_shape, self.max_npoint, rng)
                if valid.sum() >= self.min_npoint:
                    xyz = xyz_off
                    break
            if valid.sum() < self.min_npoint:
                return None
            xyz, xyz_mid = xyz[valid], xyz_mid[valid]
            rgb, sem = rgb[valid], sem[valid]
            inst = compact_instance_label(inst[valid])
        else:
            xyz_mid = data_augment(xyz0, False, False, False, False, 1.0,
                                   rng).astype(np.float32)
            xyz = xyz_mid * self.voxel_scale
            xyz = xyz - xyz.min(0)
            inst = compact_instance_label(inst)
        return xyz, xyz_mid, rgb, sem, inst

    def get(self, index: int, rng: np.random.RandomState) -> Optional[Dict[str, np.ndarray]]:
        """One transformed scene of exactly ``num_points`` points, or
        ``None`` when its crop failed."""
        path = self.filenames[index % len(self.filenames)]
        scan_id = os.path.basename(path).replace(self.suffix, "")
        out = self._transform(self.load(path), rng)
        if out is None:
            return None
        xyz, xyz_mid, rgb, sem, inst = out

        # subsample without replacement when oversized, repeat-pad when not
        n, target = xyz.shape[0], self.cfg.num_points
        if n >= target:
            sub = rng.choice(n, target, replace=False)
        else:
            sub = np.concatenate([np.arange(n), rng.choice(n, target - n, replace=True)])
        xyz, xyz_mid, rgb = xyz[sub], xyz_mid[sub], rgb[sub]
        sem, inst = sem[sub], compact_instance_label(inst[sub])

        if self.training:
            rgb = rgb + rng.randn(rgb.shape[1]).astype(np.float32) * 0.1

        # unit-cube coordinates for the dense scene grid; the offset labels
        # are in this frame, where the model groups xyz + offsets
        span = np.maximum(xyz.max(0) - xyz.min(0), 1e-6)
        xyz_unit = (xyz - xyz.min(0)) / span.max()
        inst_num, pointnum, inst_cls, offsets = instance_info(
            xyz_unit.astype(np.float32), inst, sem, self.cfg.max_instances, self.cls_offset)
        return {
            "index": scan_id,
            "xyz": xyz_unit.astype(np.float32),
            "coords_float": xyz_mid.astype(np.float32),
            "feats": rgb.astype(np.float32),
            "semantic": sem.astype(np.int32),
            "instance": inst.astype(np.int32),
            "pt_offset_label": offsets.astype(np.float32),
            "inst_num": inst_num,
            "inst_pointnum": pointnum,
            "inst_cls": inst_cls,
        }

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                shard: tuple = (0, 1),
                stride: tuple = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
        """Collated batches.

        Scene ``pos`` of the (seeded) order loads with the RandomState of
        ``(seed * 100003 + pos + 29 * attempt) % 2**31``, up to 8 attempts
        when its crop fails, so a slot's draws depend on nothing else.
        ``shard=(rank, world)``: each process collates its contiguous chunk
        of every global batch, a failed slot padded from the chunk's other
        items so every rank yields ``len(self) // batch_size`` batches.
        With one process a failed scene is skipped and the batch fills from
        the next ones (custom.py:226).  ``stride=(rank, world)``: this
        process takes batches ``rank, rank + world, ...`` (eval)."""
        rank, world = shard
        srank, sworld = stride
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        if world > 1:
            from gcanet_tpu_torch.data.abc_dataset import shard_bounds

            lo, hi = shard_bounds(batch_size, rank, world)
        else:
            lo, hi = 0, batch_size

        def load(pos: int):
            i = int(order[pos])
            for attempt in range(8):
                it = self.get(i, np.random.RandomState(
                    (seed * 100003 + pos + 29 * attempt) % (2 ** 31)))
                if it is not None:
                    return it
            return None

        if world > 1:
            for bi, start in enumerate(range(0, len(order) - batch_size + 1, batch_size)):
                if bi % sworld != srank:
                    continue
                items = [load(start + off) for off in range(lo, hi)]
                ok = [it for it in items if it is not None]
                if not ok:
                    raise RuntimeError(f"every crop in shard ({rank}/{world}) of batch {bi} "
                                       f"failed after retries")
                yield self.collate([it if it is not None else ok[0] for it in items])
            return

        items: List[Dict[str, np.ndarray]] = []
        bi = 0
        for pos in range(len(order)):
            it = load(pos)
            if it is None:
                continue
            items.append(it)
            if len(items) == batch_size:
                if bi % sworld == srank:
                    yield self.collate(items)
                items = []
                bi += 1

    def collate(self, items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return collate_scene(items, self.cfg)


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


SCANNET_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "shower curtain",
    "toilet", "sink", "bathtub", "otherfurniture")       # scannetv2.py:9-11
SCANNET_NYU_ID = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34,
                  36, 39)                                 # scannetv2.py:12


class ScanNetSceneDataset(SceneDataset):
    """scannetv2.py: instance class = semantic - 2 (the base default),
    ``.pth`` tuples of the standard preprocessing."""

    CLASSES = SCANNET_CLASSES
    NYU_ID = SCANNET_NYU_ID


class S3DISSceneDataset(SceneDataset):
    """s3dis.py: ``Area_N`` prefix lists, 6-tuple ``.pth`` payloads, no
    instance-class shift, and with ``x4_split`` a quarter subsample of each
    training scene (s3dis.py:33-40)."""

    CLASSES = ("ceiling", "floor", "wall", "beam", "column", "window", "door",
               "chair", "table", "bookcase", "sofa", "board", "clutter")

    def __init__(self, data_root: str, prefix, suffix: str, cfg: Config,
                 x4_split: bool = False, **kw):
        kw.setdefault("cls_offset", 0)
        self.x4_split = x4_split
        self._prefixes = [prefix] if isinstance(prefix, str) else list(prefix)
        super().__init__(data_root, prefix, suffix, cfg, **kw)

    def collect_filenames(self, data_root, prefix, suffix) -> List[str]:
        files: List[str] = []                              # s3dis.py:20-29
        for p in self._prefixes:
            files.extend(_glob.glob(os.path.join(data_root, p + "*" + suffix)))
        return files

    def load(self, path: str) -> Dict[str, np.ndarray]:
        import torch

        xyz, rgb, sem, inst, *_ = torch.load(path, weights_only=False)
        xyz, rgb = np.asarray(xyz), np.asarray(rgb)
        sem, inst = np.asarray(sem), np.asarray(inst)
        if self.training and self.x4_split:                # s3dis.py:33-40
            n = xyz.shape[0]
            inds = np.random.choice(n, int(n * 0.25), replace=False)
            xyz, rgb, sem = xyz[inds], rgb[inds], sem[inds]
            inst = compact_instance_label(inst[inds])
        return {"xyz": xyz, "rgb": rgb, "semantic": sem, "instance": inst}


class STPLS3DSceneDataset(SceneDataset):
    """stpls3d.py: instance class = semantic - 1 (class 0 has none)."""

    CLASSES = ("building", "low vegetation", "med. vegetation",
               "high vegetation", "vehicle", "truck", "aircraft",
               "militaryVehicle", "bike", "motorcycle", "light pole",
               "street sign", "clutter", "fence")

    def __init__(self, *args, **kw):
        kw.setdefault("cls_offset", 1)
        super().__init__(*args, **kw)


class KITTISceneDataset(SceneDataset):
    """kitti.py: raw velodyne ``.bin`` + ``.label`` pairs remapped through
    ``semantic-kitti.yaml``'s learning_map, stuff 0-10, things 11-18, ignore
    -100 (kitti.py:40-49); stuff points carry no instance (kitti.py:69-73);
    instance class = semantic - 11.  The semantic space has 19 classes:
    configure ``num_primitives=19``."""

    STUFF = ("road", "parking", "sidewalk", "otherground", "building",
             "fence", "vegetation", "trunk", "terrain", "pole",
             "traffic-sign")
    THING = ("car", "bicycle", "motorcycle", "truck", "other-vehicle",
             "person", "bicyclist", "motorcyclist")
    CLASSES = THING

    def __init__(self, data_root: str, prefix: str, suffix: str, cfg: Config, **kw):
        import yaml

        kw.setdefault("cls_offset", 11)
        with open(os.path.join(data_root, "semantic-kitti.yaml")) as f:
            sk = yaml.safe_load(f)
        self._split = sk["split"][{"train": "train", "val": "valid", "test": "test"}[prefix]]
        self._learning_map = {k: -100 if v == 0 else (v + 10 if v < 9 else v - 9)
                              for k, v in sk["learning_map"].items()}
        super().__init__(data_root, prefix, suffix, cfg, **kw)

    def collect_filenames(self, data_root, prefix, suffix) -> List[str]:
        files: List[str] = []                              # kitti.py:52-61
        for p in self._split:
            files.extend(_glob.glob(os.path.join(
                data_root, "sequences", f"{int(p):02d}", "velodyne", "*" + suffix)))
        return files

    def load(self, path: str) -> Dict[str, np.ndarray]:
        data = np.fromfile(path, np.float32).reshape(-1, 4)
        xyz, refl = data[:, :3], data[:, 3:]
        if self.with_label:
            # rewrite only the trailing velodyne/ and .bin of the path: the
            # data root itself may contain those words
            d, fname = os.path.split(path)
            label_path = os.path.join(os.path.dirname(d), "labels",
                                      fname[:-len(".bin")] + ".label")
            label = np.fromfile(label_path, np.int32)
            sem = np.vectorize(self._learning_map.__getitem__)(label & 0xFFFF)
            inst = label.copy()
            inst[sem <= 10] = -100                         # stuff: no instance
            inst = compact_instance_label(inst)
        else:
            sem = np.zeros(xyz.shape[0], np.int32)
            inst = np.zeros(xyz.shape[0], np.int32)
        return {"xyz": xyz, "rgb": refl, "semantic": sem, "instance": inst}
