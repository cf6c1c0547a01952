"""The scene data pipeline of the PyTorch port against the JAX package's
(``data/scene_dataset.py``): the augmentations from one
``np.random.RandomState``, whole batches of ``SceneDataset.batches`` over
tiny ``.npz`` and ``.pth`` scenes (train and eval, ``shard`` and
``stride``), and the S3DIS, STPLS3D and KITTI readers.  Everything is held
bit for bit: both packages make the same draws in the same order.
"""

import numpy as np
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.data import scene_dataset as jsd
from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.data import scene_dataset as sd
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

TINY = dict(num_points=256, batch_size=2, max_instances=8)
LOOSE_CROP = dict(max_npoint=10000, min_npoint=10)


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (list, str)):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("seed", [0, 1])
def test_augmentations_match_jax(seed):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(500, 3) * 4).astype(np.float32)
    for flags in [(True, True, True, True), (False, False, False, False),
                  (True, False, True, False)]:
        got = sd.data_augment(xyz, *flags, 0.7, np.random.RandomState(seed + 10))
        want = jsd.data_augment(xyz, *flags, 0.7, np.random.RandomState(seed + 10))
        np.testing.assert_array_equal(got, want)
    scaled = xyz * 50
    for gran, mag in ((6, 40.0), (20, 160.0)):
        got = sd.elastic(scaled, gran, mag, np.random.RandomState(seed))
        want = jsd.elastic(scaled, gran, mag, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
    big = rng.rand(5000, 3) * 100
    big -= big.min(0)
    for spatial, budget in ((128, 2000), (64, 300)):
        got = sd.crop(big, spatial, budget, np.random.RandomState(seed))
        want = jsd.crop(big, spatial, budget, np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1].sum() <= budget


def _write_scenes(root, split, suffix, count, n=600, seed=0):
    d = root / split
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(count):
        xyz = (rng.rand(n, 3) * 4).astype(np.float32)
        rgb = rng.rand(n, 3).astype(np.float32)
        inst = rng.randint(0, 4, n).astype(np.float32)
        inst[rng.rand(n) < 0.1] = -100
        sem = np.where(inst >= 0, inst + 2, rng.randint(0, 2, n)).astype(np.float32)
        if suffix == ".npz":
            np.savez(d / f"scene{i:04d}.npz", xyz=xyz, rgb=rgb, semantic=sem, instance=inst)
        else:
            torch.save((xyz, rgb, sem, inst), d / f"scene{i:04d}{suffix}")


BATCH_CASES = {
    "npz_train": dict(suffix=".npz", training=True, kw=dict(shuffle=True, seed=3)),
    "npz_eval": dict(suffix=".npz", training=False, kw=dict(shuffle=False)),
    "pth_train_shard": dict(suffix="_inst_nostuff.pth", training=True,
                            kw=dict(shuffle=True, seed=5, shard=(1, 2))),
    "pth_eval_stride": dict(suffix="_inst_nostuff.pth", training=False,
                            kw=dict(shuffle=False, stride=(1, 2))),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_scene_dataset_batches_match_jax(tmp_path, case):
    c = BATCH_CASES[case]
    _write_scenes(tmp_path, "train", c["suffix"], count=5)
    extra = LOOSE_CROP if c["training"] else {}
    got_ds = sd.SceneDataset(str(tmp_path), "train", c["suffix"], Config(**TINY),
                             training=c["training"], **extra)
    want_ds = jsd.SceneDataset(str(tmp_path), "train", c["suffix"], JConfig(**TINY),
                               training=c["training"], **extra)
    got = list(got_ds.batches(2, **c["kw"]))
    want = list(want_ds.batches(2, **c["kw"]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same(g, w)
    b0 = got[0]
    assert b0["xyz"].shape[1:] == (256, 3) and b0["inst_valid"].any()
    assert b0["xyz"].min() >= 0.0 and b0["xyz"].max() <= 1.0


def test_failed_crops_retry_as_jax(tmp_path):
    """A crop floor some scenes cannot reach: retried with re-salted seeds,
    skipped when every attempt fails, the same in both packages."""
    _write_scenes(tmp_path, "train", ".npz", count=4, n=400)
    kw = dict(training=True, max_npoint=250, min_npoint=240)
    got = list(sd.SceneDataset(str(tmp_path), "train", ".npz", Config(**TINY), **kw)
               .batches(1, shuffle=True, seed=1))
    want = list(jsd.SceneDataset(str(tmp_path), "train", ".npz", JConfig(**TINY), **kw)
                .batches(1, shuffle=True, seed=1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_s3dis_and_stpls3d_readers(tmp_path):
    rng = np.random.RandomState(0)
    for area in ("Area_1", "Area_2"):
        torch.save((rng.rand(400, 3).astype(np.float32), rng.rand(400, 3).astype(np.float32),
                    np.full(400, 7.0, np.float32), rng.randint(0, 3, 400).astype(np.float32),
                    None, None), tmp_path / f"{area}_office1.pth")
    for training, extra in ((False, {}), (True, dict(LOOSE_CROP, x4_split=True))):
        ds = [cls(str(tmp_path), ["Area_1", "Area_2"], ".pth", config(**TINY),
                  training=training, **extra)
              for cls, config in ((sd.S3DISSceneDataset, Config),
                                  (jsd.S3DISSceneDataset, JConfig))]
        assert len(ds[0]) == len(ds[1]) == 2
        items = []
        for d in ds:
            np.random.seed(4)               # the x4 subsample draws from the global RNG
            items.append(d.get(1, np.random.RandomState(0)))
        _same(*items)
        assert items[0]["inst_cls"][0] == 7                  # no class shift
    st = tmp_path / "st" / "train"
    st.mkdir(parents=True)
    np.savez(st / "scene.npz", xyz=rng.rand(300, 3).astype(np.float32),
             rgb=rng.rand(300, 3).astype(np.float32), semantic=np.full(300, 4.0, np.float32),
             instance=np.zeros(300, np.float32))
    items = [cls(str(tmp_path / "st"), "train", ".npz", config(**TINY), training=False)
             .get(0, np.random.RandomState(0))
             for cls, config in ((sd.STPLS3DSceneDataset, Config),
                                 (jsd.STPLS3DSceneDataset, JConfig))]
    _same(*items)
    assert items[0]["inst_cls"][0] == 3                      # semantic - 1


def test_kitti_reader(tmp_path):
    yaml = pytest.importorskip("yaml")
    root = tmp_path / "velodyne_bins"       # the root holds the words the label path rewrites
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    (seq / "labels").mkdir(parents=True)
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.rand(200, 3).astype(np.float32) * 10,
                          rng.rand(200, 1).astype(np.float32)], 1)
    pts.tofile(seq / "velodyne" / "000000.bin")
    raw = np.array([10] * 120 + [40] * 60 + [0] * 20, np.int32)
    raw[120:150] |= 1 << 16                 # two thing instances
    raw.tofile(seq / "labels" / "000000.label")
    with open(root / "semantic-kitti.yaml", "w") as f:
        yaml.safe_dump({"split": {"train": [0], "valid": [0], "test": [0]},
                        "learning_map": {0: 0, 10: 9, 40: 1}, "learning_map_inv": {}}, f)
    items = [cls(str(root), "train", ".bin", config(**TINY), training=False)
             .get(0, np.random.RandomState(0))
             for cls, config in ((sd.KITTISceneDataset, Config),
                                 (jsd.KITTISceneDataset, JConfig))]
    _same(*items)
    sem, inst = items[0]["semantic"], items[0]["instance"]
    assert set(np.unique(sem)) <= {-100, 0, 11}
    assert (inst[sem == 0] == -100).all() and (inst[sem == 11] >= 0).all()
    assert items[0]["inst_cls"][0] == 0


def test_scannet_constants_match_jax():
    assert sd.SCANNET_CLASSES == jsd.SCANNET_CLASSES
    assert sd.SCANNET_NYU_ID == jsd.SCANNET_NYU_ID
    assert sd.ScanNetSceneDataset.CLASSES == jsd.ScanNetSceneDataset.CLASSES
    for name in ("S3DISSceneDataset", "STPLS3DSceneDataset", "KITTISceneDataset"):
        assert getattr(sd, name).CLASSES == getattr(jsd, name).CLASSES
