"""The PointNet++ op kit and the SA/FP modules of the PyTorch port
(``gcanet_tpu_torch/ops/pointnet2.py``, ``models/pointnet2.py``) against the
JAX package on the same seeded inputs and weights (N <= 256).

Tolerances: integer outputs (FPS, ball-query, kNN and 3-NN indices) exact;
gathers exact; floats rtol 1e-4, atol 1e-5; new batch statistics rtol 1e-5,
atol 1e-6.  The inputs are checked to hold no near-tie that a last-bit
difference could resolve otherwise: no squared distance within 1e-5 of the
ball radius squared, kNN gaps above 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.models import pointnet2 as jmods
from gcanet_tpu.ops import pointnet2 as jp2
from gcanet_tpu_torch.models import pointnet2 as tmods
from gcanet_tpu_torch.ops import pointnet2 as tp2
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests import torch_init_law as law
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-5)
STATS = dict(rtol=1e-5, atol=1e-6)


def _cloud(seed, b=2, n=256, c=3):
    return np.random.default_rng(seed).uniform(-1, 1, (b, n, c)).astype(np.float32)


def _sqdist(a, b):
    return ((a[:, :, None, :].astype(np.float64) - b[:, None, :, :]) ** 2).sum(-1)


def _assert_no_knn_ties(d2, k):
    part = np.sort(d2, axis=-1)[..., :k + 1]
    assert np.diff(part, axis=-1).min() > 1e-5, "near-tie in the test input"


def test_furthest_point_sample_matches_jax():
    xyz = _cloud(0)
    # two distant blobs (tests/test_pointnet2.py): 2 samples take one of each
    rng = np.random.RandomState(0)
    blobs = np.concatenate([rng.randn(50, 3) * 0.01, rng.randn(50, 3) * 0.01 + 10.0])
    for cloud, s in ((xyz, 64), (blobs[None].astype(np.float32), 2)):
        want = np.asarray(jp2.furthest_point_sample(jnp.asarray(cloud), s))
        got = tp2.furthest_point_sample(torch.from_numpy(cloud), s)
        assert got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 0] < 50) != (got[0, 1] < 50)


def test_ball_query_matches_jax():
    xyz, radius = _cloud(1, n=128), 0.4
    new_xyz = xyz[:, :24]
    assert np.abs(_sqdist(new_xyz, xyz) - radius ** 2).min() > 1e-5
    want = np.asarray(jp2.ball_query(radius, 8, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    got = tp2.ball_query(radius, 8, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(got.numpy(), want)
    # tests/test_pointnet2.py's case: 3 hits padded with the first; a query
    # with no hit takes index 0
    line = np.zeros((1, 5, 3), np.float32)
    line[0, :, 0] = [0.0, 0.1, 0.2, 5.0, 6.0]
    queries = np.array([[[0.0, 0.0, 0.0], [20.0, 0.0, 0.0]]], np.float32)
    got = tp2.ball_query(0.5, 4, torch.from_numpy(line), torch.from_numpy(queries))
    np.testing.assert_array_equal(got.numpy(), [[[0, 1, 2, 0], [0, 0, 0, 0]]])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp2.ball_query(0.5, 4, jnp.asarray(line), jnp.asarray(queries))))


def test_gathers_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 4, 30)).astype(np.float32)
    idx2 = rng.integers(0, 30, (2, 7)).astype(np.int32)
    idx3 = rng.integers(0, 30, (2, 5, 6)).astype(np.int32)
    points = rng.standard_normal((2, 30, 5)).astype(np.float32)
    pairs = [(jp2.gather_operation(jnp.asarray(feats), jnp.asarray(idx2)),
              tp2.gather_operation(torch.from_numpy(feats), torch.from_numpy(idx2).long())),
             (jp2.grouping_operation(jnp.asarray(feats), jnp.asarray(idx3)),
              tp2.grouping_operation(torch.from_numpy(feats), torch.from_numpy(idx3).long())),
             (jp2.group_points(jnp.asarray(points), jnp.asarray(idx3)),
              tp2.group_points(torch.from_numpy(points), torch.from_numpy(idx3).long()))]
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_three_nn_and_interpolate_match_jax():
    known, unknown = _cloud(3, n=64), _cloud(4, n=200)
    d2 = _sqdist(unknown, known)
    _assert_no_knn_ties(d2, 8)
    jd, jidx = jp2.knn_point(8, jnp.asarray(known), jnp.asarray(unknown))
    td, tidx = tp2.knn_point(8, torch.from_numpy(known), torch.from_numpy(unknown))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **FP32)

    jdist, jidx = jp2.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    tdist, tidx = tp2.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), **FP32)

    feats = np.random.default_rng(5).standard_normal((2, 6, 64)).astype(np.float32)
    w = np.random.default_rng(6).uniform(0, 1, (2, 200, 3)).astype(np.float32)
    want = jp2.three_interpolate(jnp.asarray(feats), jidx, jnp.asarray(w))
    got = tp2.three_interpolate(torch.from_numpy(feats), tidx, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def _weights(jmod, args, seed):
    """Seeded numpy weights in the shapes of ``jmod``'s tree
    (``jax.eval_shape``: no JAX init runs): kernels N(0, 1/fan_in), BN
    scales and variances U(0.5, 1.5), biases and means N(0, 0.01)."""
    shapes = jax.eval_shape(lambda r: jmod.init(r, *args), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            w = rng.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, shapes["params"]),
            jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"]))


def _run_both(jmod, tmod, family, args, train, seeded=False):
    """``jmod`` and ``tmod`` on the same ``args`` (numpy; None passes
    through) from the same weights (``tmod``'s own draw first held to the
    JAX tree by ``tests/torch_init_law.py``, with ``seeded`` to the JAX
    module's ``init`` values of its seed 0); returns the outputs and, in
    training mode, both sides' new running statistics as port state_dicts."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if seeded:
        law.check_values(tmod, *law.jax_init(lambda r: jmod.init(r, *jargs, train=False), 0),
                         family=family)
    params, stats = _weights(jmod, jargs, 7)
    law.check_against_jax(tmod, params, stats, family=family, values=False)
    tmod.load_state_dict(state_dict_from_jax(params, stats, family=family))
    tmod.train(train)
    want, mut = jax.jit(lambda p, s, a: jmod.apply({"params": p, "batch_stats": s}, *a,
                                                   train=train, mutable=["batch_stats"]))(
        params, stats, jargs)
    got = tmod(*[None if a is None else torch.from_numpy(a) for a in args])
    new = state_dict_from_jax(params, jax.tree.map(np.asarray, mut["batch_stats"]),
                              family=family)
    return want, got, new


SA_CASES = {
    "msg": dict(npoint=16, radii=[0.5, 1.0], nsamples=[8, 16], mlps=[[16, 16], [16, 32]]),
    "single_group_all": dict(npoint=None, radii=[None], nsamples=[None], mlps=[[8, 12]]),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(SA_CASES))
def test_sa_module_matches_jax(case, train):
    """``PointnetSAModuleMSG`` (two scales) and the single-scale ``make``
    grouping all points: new centres exact, features, and in training
    mode the new running statistics."""
    kw = SA_CASES[case]
    xyz, feats = _cloud(8, n=64), _cloud(9, n=64, c=8)
    if case == "msg":
        jmod = jmods.PointnetSAModuleMSG(**kw)
        tmod = tmods.PointnetSAModuleMSG(**kw, in_channels=8)
    else:
        jmod = jmods.PointnetSAModule.make(kw["mlps"][0])
        tmod = tmods.PointnetSAModule.make(kw["mlps"][0], in_channels=8)
    (jxyz, jf), (txyz, tf), new = _run_both(jmod, tmod, "sa_msg", (xyz, feats), train,
                                            seeded=not train)
    np.testing.assert_array_equal(txyz.numpy(), np.asarray(jxyz))
    assert tf.shape == jf.shape
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf), **FP32)
    for k, v in tmod.state_dict().items():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(), err_msg=k, **STATS)


@pytest.mark.parametrize("known", [True, False], ids=["three_nn", "broadcast"])
def test_fp_module_matches_jax(known):
    """``PointnetFPModule``: interpolation from the 3 nearest known points,
    or a broadcast of one known feature row, concatenated with the unknown
    points' features; outputs and new running statistics."""
    unknown, ufeats = _cloud(10, n=128), _cloud(11, n=128, c=4)
    kxyz, kfeats = (_cloud(12, n=32), _cloud(13, n=32, c=6)) if known else (
        None, _cloud(13, n=1, c=6))
    _assert_no_knn_ties(_sqdist(unknown, _cloud(12, n=32)), 3)
    jmod, tmod = jmods.PointnetFPModule(mlp=[16, 8]), tmods.PointnetFPModule([16, 8], 10)
    want, got, new = _run_both(jmod, tmod, "fp", (unknown, kxyz, ufeats, kfeats), True,
                               seeded=known)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)
    for k, v in tmod.state_dict().items():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(), err_msg=k, **STATS)
