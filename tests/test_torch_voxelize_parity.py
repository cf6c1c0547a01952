"""The voxelize parity ops of the PyTorch port against the JAX package:
``ops/voxelize.py::voxelization_idx`` and ``voxelize_mean`` against
``gcanet_tpu/ops/voxelize.py``'s, and ``data/native.py::voxelize_idx``
against ``gcanet_tpu/data/native.py::voxelize_idx`` on its C library path
and on its numpy fallback.

Every case holds M=4096 rows (batch, x, y, z) and the JAX ops run at one
``max_voxels`` (4096), so each JAX function compiles once for the module:
duplicates (100 voxels), one batch on a 48-grid, four batch ids sharing
their xyz, and every row distinct (V equal to ``max_voxels``).  Integers
exactly; the voxel means at rtol 1e-6.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gcanet_tpu.data import native as jnative
from gcanet_tpu.ops import voxelize as jvox
from gcanet_tpu_torch.data import native as tnative
from gcanet_tpu_torch.ops import voxelize as tvox
from tests.torch_once import release_memory  # noqa: F401 (autouse)

M = MAX_VOXELS = 4096
C = 5


def _rows(rng, v, batches):
    """``v`` distinct rows over ``batches`` batch ids, xyz in [-60, 60)."""
    rows = set()
    while len(rows) < v:
        rows.add((int(rng.integers(batches)), *map(int, rng.integers(-60, 60, 3))))
    return np.array(sorted(rows), np.int32)[rng.permutation(v)]


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "duplicates":
        distinct = _rows(rng, 100, 1)
        pick = np.concatenate([np.arange(100), rng.integers(0, 100, M - 100)])
        return distinct[rng.permutation(pick)]
    if name == "one_batch":
        xyz = (rng.random((M, 3)) * 48).astype(np.int32)
        return np.concatenate([np.zeros((M, 1), np.int32), xyz], 1)
    if name == "batch_ids":
        xyz = (rng.random((M // 4, 3)) * 16).astype(np.int32)
        rows = np.concatenate([np.concatenate([np.full((M // 4, 1), b, np.int32), xyz], 1)
                               for b in range(4)])
        return rows[rng.permutation(M)]
    return _rows(rng, M, 3)                                 # "all_distinct"


CASES = ("duplicates", "one_batch", "batch_ids", "all_distinct")


@functools.cache
def _jax_fns():
    return (jax.jit(jvox.voxelization_idx, static_argnums=1),
            jax.jit(jvox.voxelize_mean, static_argnums=2))


@pytest.mark.parametrize("case", CASES)
def test_voxelization_idx_matches_jax(case):
    coords = _case(case)
    want = [np.asarray(a) for a in _jax_fns()[0](coords, MAX_VOXELS)]
    got = [t.numpy() for t in tvox.voxelization_idx(torch.from_numpy(coords), MAX_VOXELS)]
    v = int(want[2])
    assert v == len(np.unique(coords, axis=0))
    assert v == MAX_VOXELS if case == "all_distinct" else v < MAX_VOXELS
    for g, w, name in zip(got, want, ("out_coords", "p2v", "num_voxels")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_voxelize_mean_matches_jax(case):
    coords = _case(case)
    p2v = tvox.voxelization_idx(torch.from_numpy(coords), MAX_VOXELS)[1]
    feats = np.random.default_rng(7).standard_normal((M, C)).astype(np.float32)
    want = np.asarray(_jax_fns()[1](feats, p2v.numpy(), MAX_VOXELS))
    got = tvox.voxelize_mean(torch.from_numpy(feats), p2v, MAX_VOXELS).numpy()
    assert got.shape == want.shape == (MAX_VOXELS, C)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_native_voxelize_idx_matches_jax(case, monkeypatch):
    """The port's numpy ``voxelize_idx`` against the JAX package's C library
    path and its numpy fallback, and against the port's device op."""
    coords = _case(case)
    got = tnative.voxelize_idx(coords)
    assert jnative._load() is not None, "the JAX package's C library did not load"
    with_c = jnative.voxelize_idx(coords)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    fallback = jnative.voxelize_idx(coords)
    for want in (with_c, fallback):
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    out, p2v, v = tvox.voxelization_idx(torch.from_numpy(coords), MAX_VOXELS)
    np.testing.assert_array_equal(out[:got[2]].numpy(), got[0])
    np.testing.assert_array_equal(p2v.numpy(), got[1])
