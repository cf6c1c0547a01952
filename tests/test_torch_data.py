"""The port's ABC data path against the JAX package's: the augmentation
routines, ``relabel`` and ``instance_info`` (the JAX side takes its native
library where it builds, else its numpy loop), ``process_object`` and
``ABCDataset.batches``, on small h5 files written here in the reference's
layout (``gcanet_tpu/data/process_abc.py::pack_h5``).

The augmentation routines draw from the global ``np.random`` stream, so it
is seeded the same before each side.  Integers exact; floats rtol 1e-6
(the same float32 arithmetic; the tolerance covers the JAX numpy loop's
float32 centroid where its native library is absent).
"""

import os

import h5py
import numpy as np
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.data import abc_dataset as jds
from gcanet_tpu.data import augment as jaug
from gcanet_tpu.data import native as jnative
from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.data import abc_dataset as tds
from gcanet_tpu_torch.data import augment as taug
from gcanet_tpu_torch.data import native as tnative
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

FLOAT = dict(rtol=1e-6, atol=1e-6)
SMALL = dict(num_points=128, max_instances=6)
NAMES = [f"{i:08d}" for i in range(7)]
SIZES = [150, 120, 101, 100, 30, 19]


def _raw_object(rng):
    """Instances of 150, 120, 101, 100, 30 and 19 points (the last three
    become background) with raw ids in random order, shuffled; classes 0-9
    so the fold acts."""
    n_raw = sum(SIZES)
    labels = np.repeat(rng.permutation(np.arange(10, 70, 10)), SIZES)
    prim = np.repeat(rng.integers(0, 10, len(SIZES)), SIZES)
    perm = rng.permutation(n_raw)
    normals = rng.standard_normal((n_raw, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return {"points": rng.random((n_raw, 3)).astype(np.float32),
            "labels": labels[perm].astype(np.int64),
            "normals": normals.astype(np.float32),
            "prim": prim[perm].astype(np.int64),
            "T_param": rng.standard_normal((n_raw, 22)).astype(np.float32)}


@pytest.fixture(scope="module")
def abc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("abc")
    rng = np.random.default_rng(0)
    for name in NAMES:
        with h5py.File(root / f"{name}.h5", "w") as hf:
            for k, v in _raw_object(rng).items():
                hf.create_dataset(k, data=v)
    (root / "train_data.txt").write_text("\n".join(NAMES) + "\n")
    return str(root)


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (list, str, int)):
            assert g == w, k
        elif np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=k, **FLOAT)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("index", range(len(jaug.AUGMENT_ROUTINES)))
def test_augmentation_routines_match_jax(index):
    pts = np.random.RandomState(1).rand(2, 50, 3).astype(np.float32)
    np.random.seed(11)
    want = jaug.AUGMENT_ROUTINES[index](pts)
    np.random.seed(11)
    got = taug.AUGMENT_ROUTINES[index](pts)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **FLOAT)
    assert not np.allclose(got, pts)


def test_relabel_and_instance_info_match_jax():
    rng = np.random.default_rng(2)
    for case in range(4):
        raw = _raw_object(rng)
        labels, prim = raw["labels"], raw["prim"]
        if case == 1:
            labels = labels % 7                 # merge instances: others cross 100
        for fold7 in (True, False):
            got, want = tnative.relabel(labels, prim, 100, fold7), \
                jnative.relabel(labels, prim, 100, fold7)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        lbl, cls = want
        # the first kept raw label to occur gets id 0, whatever its value
        assert lbl[0] == 0 or lbl[0] == -1
        xyz = raw["points"]
        for max_inst in (2, 3, 80):             # the cap, and points beyond it
            got = tnative.instance_info(xyz, lbl, cls, max_inst)
            want = jnative.instance_info(xyz, lbl, cls, max_inst)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_allclose(got[3], want[3], **FLOAT)
            assert got[3].dtype == np.float32
    empty = np.zeros(0, np.int64)
    for g, w in zip(tnative.relabel(empty, empty), jnative.relabel(empty, empty)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("training", [False, True])
def test_process_object_matches_jax(abc_root, training):
    kw = dict(SMALL, augment=1, if_normal_noise=1) if training else SMALL
    raw = jds.load_h5_object(os.path.join(abc_root, NAMES[0] + ".h5"))
    np.testing.assert_array_equal(tds.load_h5_object(os.path.join(abc_root, NAMES[0] + ".h5"))
                                  ["labels"], raw["labels"])
    for seed in (0, 1, 2, 3, 10):               # seeds that draw each routine once
        np.random.seed(seed)
        want = jds.process_object(raw, JConfig(**kw), training, np.random.RandomState(seed))
        np.random.seed(seed)
        got = tds.process_object(raw, Config(**kw), training, np.random.RandomState(seed))
        _assert_items_equal(got, want)
    assert (want["I_gt"] == -1).any() and want["inst_num"] >= 2


@pytest.mark.parametrize("part", ["whole", "shard", "stride"])
def test_dataset_batches_match_jax(abc_root, part):
    kw = dict(SMALL, augment=1)
    ds = {"port": tds.ABCDataset(abc_root, "train_data.txt", Config(**kw), skip=2, fold=3),
          "jax": jds.ABCDataset(abc_root, "train_data.txt", JConfig(**kw), skip=2, fold=3)}
    assert len(ds["port"]) == len(ds["jax"]) == 12
    for rank in (0, 1):
        arg = {"whole": {}, "shard": {"shard": (rank, 2)}, "stride": {"stride": (rank, 2)}}[part]
        got = {}
        for side, d in ds.items():
            np.random.seed(7)
            got[side] = list(d.batches(4, shuffle=True, seed=3, **arg))
        assert len(got["port"]) == len(got["jax"]) > 0
        for g, w in zip(got["port"], got["jax"]):
            _assert_items_equal(g, w)
        assert got["port"][0]["gt_pc"].shape[0] == (2 if part == "shard" else 4)


def test_load_h5_object_needs_h5py_only_to_read(abc_root, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        tds.load_h5_object(os.path.join(abc_root, NAMES[0] + ".h5"))
