"""Grouping, voxelisation and instance extraction of the PyTorch port against
the JAX package on the SAME inputs: gaussian blob clusters (as
tests/test_grouping.py builds them) with fragments placed beside primaries,
so there are real proposals, kept fragments and set-aggregation absorptions.
Integer outputs must match exactly; float outputs (voxel features, conf) at
rtol=1e-5, atol=1e-6 — the same fp32 sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.ops import grouping as jgrouping
from gcanet_tpu.ops import voxelize as jvox
from gcanet_tpu.train import instances as jinst
from gcanet_tpu_torch.config import GroupingConfig
from gcanet_tpu_torch.ops import grouping as tgrouping
from gcanet_tpu_torch.ops import voxelize as tvox
from gcanet_tpu_torch.train import instances as tinst
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

C = 3
P = 24
CFG = dict(radius=0.03, min_npoint=5, class_numpoint_mean=(100.0, 100.0, 100.0))


def _blobs(seed, n=300):
    """Per item: three primaries (>= 0.3*100 points), a kept fragment and
    two small fragments next to same-class primaries, and filler blobs."""
    rng = np.random.RandomState(seed)
    sizes = [80, 60, 45, 12, 4, 3]
    sizes.append(n - sum(sizes))
    centers = rng.rand(len(sizes), 3) * 3
    cls = [0, 1, 2, 0, 1, 0, 2]
    centers[3] = centers[0] + [0.06, 0, 0]          # kept fragment by primary 0
    centers[4] = centers[1] + [0, 0.06, 0]          # small fragment by primary 1
    centers[5] = centers[0] + [0, 0, -0.07]
    pts, pcls, emb = [], [], []
    for i, (m, c) in enumerate(zip(sizes, cls)):
        pts.append(centers[i] + 0.003 * rng.randn(m, 3))
        pcls.append(np.full(m, c))
        emb.append(np.repeat(rng.randn(1, 8), m, 0) + 0.001 * rng.randn(m, 8))
    perm = rng.permutation(n)
    cat = lambda xs: np.concatenate(xs)[perm].astype(np.float32)
    return (cat(pts), cat(pcls).astype(np.int32), cat(emb),
            rng.randn(n, 22).astype(np.float32))


@pytest.fixture(scope="module")
def inputs():
    items = [_blobs(s) for s in (0, 1)]
    return [np.stack(x) for x in zip(*items)]        # shifted, cls, emb, param


@pytest.mark.parametrize("set_aggr,neighbor_cap", [(False, 0), (True, 0), (False, 20)])
def test_build_proposals_exact(inputs, set_aggr, neighbor_cap):
    # neighbor_cap 20 cuts the 45-80-point blobs' rows: a directed graph,
    # propagated along incoming edges (the transpose, grouping.py:238-245)
    want = jgrouping.build_proposals(*map(jnp.asarray, inputs), num_classes=C,
                                     cfg=JGroupingConfig(**CFG, neighbor_cap=neighbor_cap),
                                     max_proposals=P, using_set_aggr=set_aggr)
    got = tgrouping.build_proposals(*map(torch.from_numpy, inputs), num_classes=C,
                                    cfg=GroupingConfig(**CFG, neighbor_cap=neighbor_cap),
                                    max_proposals=P, using_set_aggr=set_aggr)
    assert int(got.num) > 0
    if set_aggr:
        assert (got.point_pid[1] >= 0).any(), "no absorption exercised"
    for name in tgrouping.Proposals._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_gated_mask_and_classes(inputs):
    shifted, cls, emb, param = (x[0] for x in inputs)
    want = jgrouping.gated_neighbor_mask(*map(jnp.asarray, (shifted, cls, emb, param)),
                                         C, JGroupingConfig(**CFG, similarity_threshold_para=0.5))
    got = tgrouping.gated_neighbor_mask(*map(torch.from_numpy, (shifted, cls, emb, param)),
                                        C, GroupingConfig(**CFG, similarity_threshold_para=0.5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def jax_props(inputs):
    props = jgrouping.build_proposals(*map(jnp.asarray, inputs), num_classes=C,
                                      cfg=JGroupingConfig(**CFG), max_proposals=P,
                                      using_set_aggr=True)
    return [np.array(x) for x in props]       # point_pid, valid, cls, batch, size, num


def test_clusters_voxelization(inputs, jax_props):
    shifted, _, emb, _ = inputs
    pid = jax_props[0]
    coords = shifted.reshape(-1, 3)
    feats = emb.reshape(-1, emb.shape[-1])
    want = jvox.clusters_voxelization(jnp.asarray(coords), jnp.asarray(feats),
                                      jnp.asarray(pid), num_proposals=P, grid_size=8)
    got = tvox.clusters_voxelization(torch.from_numpy(coords), torch.from_numpy(feats),
                                     torch.from_numpy(pid), num_proposals=P, grid_size=8)
    assert got.active.any()
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    np.testing.assert_array_equal(got.entry_voxel.numpy(), np.asarray(want.entry_voxel))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=1e-5, atol=1e-6)


def test_merged_labels_and_instances(jax_props):
    pid, valid, _, batch = jax_props[:4]
    rng = np.random.default_rng(3)
    cls_scores = rng.standard_normal((P, 7)).astype(np.float32)
    cls_scores[np.arange(P), rng.integers(0, 7, P)] += 6.0    # confident classes
    iou = rng.uniform(-0.2, 1.2, (P, 7)).astype(np.float32)
    mask = rng.normal(0.0, 2.0, (2, pid.shape[1], 7)).astype(np.float32)
    args = (pid, cls_scores, iou, mask, valid)
    for min_npoint in (20, 150):
        want = jinst.merged_labels_device(*map(jnp.asarray, args), 7, min_npoint=min_npoint)
        got = tinst.merged_labels_device(*map(torch.from_numpy, args), 7,
                                         min_npoint=min_npoint)
        if min_npoint == 20:
            assert int(got[1].sum()) > 0 and int(got[4].sum()) > 0
        want = [np.asarray(w) for w in want]
        got = [g.numpy() for g in got]
        for name, g, w in zip(("merged", "keep", "conf", "npoint", "covered"), got, want):
            if name == "conf":
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
        n = 300
        for b in range(2):
            sl = slice(b * n, (b + 1) * n)
            kw = dict(prop_mask=batch == b)
            wl = jinst.instances_from_merged(want[0][sl], *want[1:4], want[4][sl], **kw)
            gl = tinst.instances_from_merged(got[0][sl], *got[1:4], got[4][sl], **kw)
            assert [(i["label_id"], i["npoint"], i["pred_mask"]) for i in gl] == \
                   [(i["label_id"], i["npoint"], i["pred_mask"]) for i in wl]
            np.testing.assert_allclose([i["conf"] for i in gl], [i["conf"] for i in wl],
                                       rtol=1e-6)


def test_rle_roundtrip_matches_jax():
    m = np.random.default_rng(4).random(1000) < 0.3
    assert tinst.rle_encode(m) == jinst.rle_encode(m)
    np.testing.assert_array_equal(tinst.rle_decode(jinst.rle_encode(m)), m.astype(np.uint8))


def _scene_blobs(seed, n=400):
    """Blobs of several classes on a 2**-10 grid (squared distances exact in
    float32, so no pair sits on the radius in one framework only), some of
    them touching a blob of another class, and class ids past the mean table."""
    rng = np.random.RandomState(seed)
    sizes = [90, 70, 60, 40, 30, 25, 20, 15, 10]
    sizes.append(n - sum(sizes))
    centers = rng.rand(len(sizes), 3) * 0.8 + 0.1
    centers[1] = centers[0] + [0.03, 0, 0]          # touches blob 0, another class
    pts = np.concatenate([c + 0.01 * rng.randn(m, 3) for c, m in zip(centers, sizes)])
    sem = np.concatenate([np.full(m, k % 5) for k, m in enumerate(sizes)])
    sem[sem == 4] = 7
    return (np.round(pts * 1024) / 1024).astype(np.float32), sem.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_simple_clusters_matches_jax(seed):
    # the JAX test's own case, then multi-class scenes: labels and keep exactly
    rng = np.random.RandomState(5)
    coords = np.concatenate([0.01 * rng.randn(60, 3), 0.01 * rng.randn(10, 3) + 5.0])
    cases = [(coords.astype(np.float32), np.zeros(70, np.int32), 0.2, 0.15, (200.0,)),
             (*_scene_blobs(seed), 0.03, 0.3, (100.0, 60.0, 80.0, -1.0))]
    for xyz, sem, radius, thr, means in cases:
        want = jgrouping.simple_clusters(jnp.asarray(xyz), jnp.asarray(sem), radius, thr, means)
        got = tgrouping.simple_clusters(torch.from_numpy(xyz), torch.from_numpy(sem), radius,
                                        thr, means)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert 0 < int(got[1].sum()) < len(xyz)
