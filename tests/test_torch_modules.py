"""Modules of the PyTorch port against the JAX package on the same inputs
and weights: kNN, the encoder's 1280-d features, the heads, the offset
module and the instance head.

Weights: one jitted ``PrimitiveNet.init`` tree, with every bias, norm scale
and BN running statistic perturbed by seeded numpy noise (so no layer runs
at its identity initialisation), carried to the port by
``state_dict_from_jax``.  Tolerance for fp32: rtol=1e-4, atol=1e-5 — the
same fp32 math, summed in a different order by the two frameworks.  The
bf16 instance head is held at atol=rtol=3e-2 because bf16 (8 bits of
mantissa) rounds at different places in the two frameworks' convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.models.dgcnn import DGCNNEncoderGn as JEncoder
from gcanet_tpu.models.instance_head import InstanceHead as JInstanceHead
from gcanet_tpu.models.offset import OffsetPredModule as JOffset
from gcanet_tpu.models.primitive_net import PrimitiveNet as JPrimitiveNet
from gcanet_tpu.ops import knn as jknn
from gcanet_tpu_torch.config import Config, InstanceHeadConfig
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.ops import knn as tknn
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests import torch_init_law as law
from tests.torch_once import jit_init, once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
N, B, G, P = 256, 2, 8, 16
SMALL = dict(num_points=N, nn_nb=12, nn_nb_inner=8, offset_knn=6,
             offset_keypoints=24, knn_impl="xla")


def perturb(tree, rng):
    """Seeded noise on every bias / norm scale / BN statistic of a flax tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k in ("bias", "mean"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _jax_init(jmodel):
    z = jnp.zeros((1, N, 3))
    v = jit_init(lambda r: jmodel.init({"params": r}, z, z, train=True, rng=r),
                 jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, (v["params"], v["batch_stats"]))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX model and the port's, on the same perturbed weights.  First
    the port's own draw is held to flax's truncated lecun-normal
    (``tests/torch_init_law.py``): the default flagship (4.4 million
    weights, built only) by its bound and law, the small one against the
    JAX ``PrimitiveNet.init`` values."""
    jcfg = JConfig(**SMALL, instance_head=JIHConfig(grid_size=G, max_proposals=P))
    jmodel = JPrimitiveNet(jcfg)
    init_params, init_stats = once(tmp_path_factory, "modules_init", lambda: _jax_init(jmodel))
    tmodel = PrimitiveNet(Config(**SMALL, instance_head=InstanceHeadConfig(
        grid_size=G, max_proposals=P)))
    law.check_law([PrimitiveNet(Config())])
    law.check_against_jax(tmodel, init_params, init_stats, family="flagship", values=True)
    rng = np.random.default_rng(0)
    params = perturb(init_params, rng)
    stats = perturb(init_stats, rng)
    tmodel.load_state_dict(state_dict_from_jax(params, stats))
    return jmodel, params, stats, tmodel.eval()


def _cloud(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    nrm = rng.standard_normal((B, N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return xyz, nrm


def test_knn_sets_match_by_distance():
    xyz, nrm = _cloud(1)
    x6 = np.concatenate([xyz, nrm], -1)
    feats = np.random.default_rng(2).standard_normal((B, N, 64)).astype(np.float32)
    for fn_j, fn_t, x, metric in [
            (jknn.knn_points_normals_indices, tknn.knn_points_normals_indices, x6,
             jknn.pairwise_dist_points_normals),
            (jknn.knn_indices, tknn.knn_indices, feats, jknn.pairwise_sqdist)]:
        want = np.asarray(fn_j(jnp.asarray(x), 12, "xla"))
        got = fn_t(torch.from_numpy(x), 12, "approx").numpy()
        d = np.asarray(metric(jnp.asarray(x)))
        # nearest-first order, same distances (indices may differ on ties)
        np.testing.assert_allclose(np.take_along_axis(d, got, -1),
                                   np.take_along_axis(d, want, -1), rtol=1e-5, atol=1e-6)
        assert (np.diff(np.take_along_axis(d, got, -1), axis=-1) >= 0).all()


def test_encoder_features(models):
    jmodel, params, _, tmodel = models
    xyz, nrm = _cloud(3)
    x6 = np.concatenate([xyz, nrm], -1)
    enc = JEncoder(mode=5, nn_nb=12, knn_impl="xla", nn_nb_inner=8)  # shared_graph off
    want = np.asarray(jax.jit(enc.apply)({"params": params["DGCNNEncoderGn_0"]},
                                         jnp.asarray(x6)))
    with torch.no_grad():
        got = tmodel.encoder(torch.from_numpy(x6)).numpy()
    assert got.shape == (B, N, 1280)
    np.testing.assert_allclose(got, want, **FP32)


def test_heads_and_offsets_full_forward(models):
    jmodel, params, stats, tmodel = models
    xyz, nrm = _cloud(4)
    fwd = jax.jit(lambda p, s, a, b: jmodel.apply({"params": p, "batch_stats": s},
                                                   a, b, train=False,
                                                   rng=jax.random.PRNGKey(0)))
    want = fwd(params, stats, jnp.asarray(xyz), jnp.asarray(nrm))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(xyz), torch.from_numpy(nrm))
    for name in ("type_per_point", "param_per_point", "semantic_scores",
                 "embedding", "pt_offsets"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), err_msg=name, **FP32)


def test_offset_module(models):
    _, params, _, tmodel = models
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    feat = rng.standard_normal((B, N, 128)).astype(np.float32)
    inst = rng.standard_normal((B, N, 64)).astype(np.float32)
    want = np.asarray(jax.jit(JOffset(6, 24).apply)(
        {"params": params["OffsetPredModule_0"]},
        jnp.asarray(pts), jnp.asarray(feat), jnp.asarray(inst)))
    with torch.no_grad():
        got = tmodel.offset_pred_block(*map(torch.from_numpy, (pts, feat, inst))).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def _head_inputs(seed):
    rng = np.random.default_rng(seed)
    g3 = G ** 3
    active = rng.random((P, g3)) < 0.3
    feats = (rng.standard_normal((P, g3, 64)) * active[..., None]).astype(np.float32)
    pid = rng.integers(-1, P, (2, B * N)).astype(np.int32)
    vox = np.where(pid >= 0, rng.integers(0, g3, (2, B * N)), -1).astype(np.int32)
    return feats, active, vox, pid


@pytest.mark.parametrize("bf16", [False, True])
def test_instance_head(models, bf16):
    _, params, stats, tmodel = models
    feats, active, vox, pid = _head_inputs(6)
    head = JInstanceHead(num_classes=7, channels=64, grid_size=G, compute_bf16=bf16)
    want = jax.jit(lambda p, s, *a: head.apply({"params": p, "batch_stats": s}, *a, False))(
        params["InstanceHead_0"], stats["InstanceHead_0"], *map(jnp.asarray, (feats, active, vox, pid)))
    thead = tmodel.instance_head
    thead.compute_bf16 = bf16
    try:
        with torch.no_grad():
            got = thead(*map(torch.from_numpy, (feats, active, vox, pid)))
    finally:
        thead.compute_bf16 = True
    tol = BF16 if bf16 else FP32
    for name in ("cls_scores", "iou_scores", "mask_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), err_msg=name, **tol)
